"""Training losses: geodesic pose, residual and flow supervision (port of
``dbaf_tpu/train/losses.py``).

The reference's training objectives (geom/losses.py:9-118): sums over the
unrolled update iterations weighted by gamma^(n-i-1).  Metrics come back as
0-d tensors on the losses' device (no host read).  With a process ``group``
the edges are this rank's share of the tuple's: every sum and mean over
edges runs over the group (differentiably), and the results are the same
on every rank.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ..ops import lie, projective as pj, sim3
from ..parallel.collectives import all_sum, mean


def fit_scale(Ps: torch.Tensor, Gs: torch.Tensor, group=None) -> torch.Tensor:
    """Least-squares translation scale between pose sets (losses.py:22-28)."""
    t1 = Ps[..., :3].reshape(-1)
    t2 = Gs[..., :3].reshape(-1)
    if group is None:
        return torch.sum(t1 * t2) / (torch.sum(t2 * t2) + 1e-8)
    s = all_sum(torch.stack([torch.sum(t1 * t2), torch.sum(t2 * t2)]), group)
    return s[0] / (s[1] + 1e-8)


def pose_metrics(dE: torch.Tensor, group=None) -> Dict[str, torch.Tensor]:
    """Translation / rotation (/ scale) error metrics (losses.py:9-18).
    SE3 7-vectors or Sim3 8-vectors; the Sim3 form adds ``|s - 1|``."""
    r_err = torch.rad2deg(torch.linalg.norm(lie.so3_log(dE[..., 3:7]), dim=-1))
    t_err = torch.linalg.norm(dE[..., :3], dim=-1)
    out = {
        "rot_error": mean(r_err, group),
        "tr_error": mean(t_err, group),
        "bad_rot": mean((r_err < 0.1).float(), group),
        "bad_tr": mean((t_err < 0.01).float(), group),
    }
    if dE.shape[-1] == 8:
        out["scale_error"] = mean(torch.abs(dE[..., 7] - 1.0), group)
    return out


def _norm_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    return mean(torch.linalg.norm(x, dim=-1), group)


def geodesic_loss(Ps: torch.Tensor, Gs_list: Sequence[torch.Tensor], ii: torch.Tensor,
                  jj: torch.Tensor, gamma: float = 0.9, do_scale: bool = True,
                  group=None) -> Tuple[torch.Tensor, Dict]:
    """Relative-pose geodesic loss over the unrolled estimates
    (losses.py:30-74).  Ps: (N, 7) ground truth; Gs_list: the iterates,
    each (N, 7) SE3 or (N, 8) Sim3 (Sim3 adds the ``0.05 * |sigma|``
    scale-drift term).  The metrics are those of the Sim3 lift."""
    is_sim3 = Gs_list[0].shape[-1] == 8
    if is_sim3:
        dP = sim3.rel(sim3.from_se3(Ps[ii]), sim3.from_se3(Ps[jj]))
    else:
        dP = lie.se3_rel(Ps[ii], Ps[jj])
    n = len(Gs_list)
    total = 0.0
    metrics = {}
    for i, Gs in enumerate(Gs_list):
        w = gamma ** (n - i - 1)
        if is_sim3:
            dG = sim3.rel(Gs[ii], Gs[jj])
            if do_scale:
                dG = sim3.scale(dG, fit_scale(dP, dG, group))
            dE = sim3.mul(dG, sim3.inv(dP))
            d = sim3.log(dE)
            total = total + w * (_norm_mean(d[..., :3], group) + _norm_mean(d[..., 3:6], group)
                                 + 0.05 * _norm_mean(d[..., 6:], group))
        else:
            dG = lie.se3_rel(Gs[ii], Gs[jj])
            if do_scale:
                s = fit_scale(dP, dG, group)
                dG = torch.cat([dG[..., :3] * s, dG[..., 3:]], dim=-1)
            dE = lie.se3_mul(dG, lie.se3_inv(dP))
            d = lie.se3_log(dE)
            total = total + w * (_norm_mean(d[..., :3], group) + _norm_mean(d[..., 3:], group))
            dE = sim3.from_se3(dE)
        metrics = pose_metrics(dE, group)
    return total, metrics


def residual_loss(residuals: Sequence[torch.Tensor], gamma: float = 0.9, group=None):
    """Weighted mean-abs system residuals (losses.py:77-86)."""
    n = len(residuals)
    total = 0.0
    for i, r in enumerate(residuals):
        total = total + gamma ** (n - i - 1) * mean(torch.abs(r), group)
    return total, {"residual": total}


def flow_loss(Ps: torch.Tensor, disps: torch.Tensor, poses_est: Sequence[torch.Tensor],
              disps_est: Sequence[torch.Tensor], intrinsics: torch.Tensor, gamma: float = 0.9):
    """End-point error against the ground-truth induced flow on the +-1
    neighbour graph (losses.py:89-118)."""
    N = Ps.shape[0]
    ar = torch.arange(N, device=Ps.device)
    ii = torch.cat([ar[:-1], ar[1:]])
    jj = torch.cat([ar[1:], ar[:-1]])

    coords0, val0 = pj.projective_transform(Ps, disps, intrinsics, ii, jj)
    val0 = val0 * (disps[ii] > 0).to(val0.dtype)[..., None]

    n = len(poses_est)
    total = 0.0
    epe = v = None
    for i in range(n):
        w = gamma ** (n - i - 1)
        coords1, val1 = pj.projective_transform(poses_est[i], disps_est[i], intrinsics, ii, jj)
        v = (val0 * val1)[..., 0]
        epe = v * torch.linalg.norm(coords1 - coords0, dim=-1)
        total = total + w * torch.mean(epe)

    mask = v > 0.5
    valid_epe = torch.where(mask, epe, torch.zeros_like(epe))
    cnt = torch.clamp(torch.sum(mask), min=1)
    one = torch.ones_like(epe)
    metrics = {
        "f_error": torch.sum(valid_epe) / cnt,
        "1px": torch.sum(torch.where(mask & (epe < 1.0), one, torch.zeros_like(one))) / cnt,
    }
    return total, metrics
