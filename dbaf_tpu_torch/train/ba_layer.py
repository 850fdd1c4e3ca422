"""Differentiable bundle-adjustment layer for training (port of
``dbaf_tpu/train/ba_layer.py``).

The training-time BA of the reference (geom/ba.py:29-155 with chol.py's
damping) on the port's dense-BA pieces (:mod:`dbaf_tpu_torch.ops.dba`).
Autograd runs through ``cholesky_ex`` and ``cholesky_solve``; the
training clamps are the reference's (disps > 10 -> 0, then min 0).  With a
process ``group`` the edges are this rank's share, and the pairwise
assembly gathers and sums over the ranks (``parallel/shard_ba.py``; its
collectives are differentiable).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops import dba


def ba_step(target: torch.Tensor, weight: torch.Tensor, eta: torch.Tensor, poses: torch.Tensor,
            disps: torch.Tensor, intrinsics: torch.Tensor, ii: torch.Tensor, jj: torch.Tensor,
            fixedp: int = 2, ep: float = 0.1, lm: float = 1e-4,
            group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One full-BA Gauss-Newton step (geom/ba.py:29-104).

    target/weight: (E, H, W, 2); eta: (P, H*W) depth damping from GraphAgg.
    Poses before ``fixedp`` stay fixed (the gauge)."""
    P = poses.shape[0]
    mask = torch.ones(ii.shape, dtype=torch.bool, device=ii.device)
    es = dba.build_edge_system(poses, disps, intrinsics, target, weight, ii, jj, mask)
    ps = dba.assemble_pairwise(es, ii, jj, P, fixedp, P, eta + 1e-7, group=group)
    dx = dba.damped_solve(ps.S, ps.v, ps.pose_active, lm, ep)
    dz = dba.back_substitute_pairwise(ps, es, ii, jj, dx, fixedp, P, group)
    depth_active = torch.ones((P,), dtype=torch.bool, device=poses.device)
    poses, disps = dba.retract(poses, disps, dx, dz, ps.pose_active, depth_active)
    # training clamps (geom/ba.py:101-102)
    disps = torch.where(disps > 10.0, torch.zeros_like(disps), disps)
    return poses, torch.clamp(disps, min=0.0)


def motion_only_ba_step(target, weight, eta, poses, disps, intrinsics, ii, jj, fixedp: int = 1,
                        ep: float = 0.1, lm: float = 1e-4) -> torch.Tensor:
    """Motion-only variant (geom/ba.py:107-155): the poses after one step."""
    P = poses.shape[0]
    mask = torch.ones(ii.shape, dtype=torch.bool, device=ii.device)
    es = dba.build_edge_system(poses, disps, intrinsics, target, weight, ii, jj, mask)
    ws = dba.assemble_window_system(es, ii, jj, P, fixedp, P, eta + 1e-7)
    dx = dba.damped_solve(ws.A, ws.b, ws.pose_active, lm, ep)
    poses, _ = dba.retract(poses, disps, dx, torch.zeros_like(ws.C), ws.pose_active)
    return poses
