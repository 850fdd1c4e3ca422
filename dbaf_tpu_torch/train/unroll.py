"""Unrolled training forward pass of the full system (port of
``dbaf_tpu/train/unroll.py``).

The training graph of the reference (droid_net.py:171-221): feature
extraction -> per-edge correlation volume -> ``num_steps`` iterations of
(lookup -> update operator with GraphAgg -> 2 x differentiable BA) ->
convex-upsampled disparities and weighted residuals for the losses.  The
volume is built once and looked up with the plain ``lookup_fused``, as the
JAX unroll does; no hand kernel runs on this path.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..models.net import DroidNet
from ..ops import corr as corr_ops
from ..ops import projective as pj
from .ba_layer import ba_step


def cvx_upsample(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex 8x upsampling with learned 3 x 3 masks (droid_net.py:17-31).

    data: (N, H, W, C); mask: (N, H, W, 9*64), softmax over the 9 taps
    (row-major 3 x 3, as torch's unfold orders them).  Returns
    (N, 8H, 8W, C)."""
    N, H, W, C = data.shape
    m = torch.softmax(mask.reshape(N, H, W, 9, 8, 8), dim=3)
    pad = torch.nn.functional.pad(data, (0, 0, 1, 1, 1, 1))
    taps = torch.stack([pad[:, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)],
                       dim=3)  # (N, H, W, 9, C)
    up = torch.einsum("nhwkab,nhwkc->nhwabc", m.to(taps.dtype), taps)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(N, 8 * H, 8 * W, C)


def upsample_disp(disp: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N, H, W) disparity + (N, H, W, 576) mask -> (N, 8H, 8W)."""
    return cvx_upsample(disp[..., None], mask)[..., 0]


def forward(model: DroidNet, images: torch.Tensor, poses0: torch.Tensor, disps0: torch.Tensor,
            intrinsics: torch.Tensor, ii: torch.Tensor, jj: torch.Tensor, num_steps: int = 12,
            fixedp: int = 2, group=None) -> Tuple[List, List, List]:
    """Unrolled estimation (droid_net.py:171-221).

    images: (N, H, W, 3) BGR-valued; poses0: (N, 7); disps0: (N, H/8, W/8);
    intrinsics: (4,) at 1/8 scale; ii, jj: (E,) int64.  Returns
    (poses_list, disps_up_list, residuals_list) for the training losses.
    The pose, disparity and target iterates are detached at the top of
    every step, where the JAX unroll stops their gradients.  With a process
    ``group``, ``ii``/``jj`` are this rank's share of the edges: GraphAgg's
    per-frame mean and the BA layer reduce over the group, and the poses,
    disparities and GraphAgg's outputs come out the same on every rank."""
    fmaps, net_c, inp_c = model.extract_features(images)
    net = net_c[ii]
    inp = inp_c[ii]
    vol = corr_ops.build_volume_nhwc(fmaps[ii], fmaps[jj])

    h8, w8 = disps0.shape[-2:]
    grid = pj.coords_grid(h8, w8, device=disps0.device)

    poses, disps = poses0, disps0
    coords1, _ = pj.projective_transform(poses, disps, intrinsics, ii, jj)
    target = coords1

    poses_list, disps_list, residual_list = [], [], []
    N = poses.shape[0]
    for _ in range(num_steps):
        poses, disps = poses.detach(), disps.detach()
        coords1, target = coords1.detach(), target.detach()

        corr = corr_ops.lookup_fused(vol, coords1).permute(0, 2, 3, 1)
        motn = torch.cat([coords1 - grid, target - coords1], dim=-1).clamp(-64.0, 64.0)
        net, delta, weight, eta, upmask = model.update_with_agg(net, inp, corr, motn, ii, N, group)
        target = coords1 + delta

        eta_frames = eta.reshape(N, h8 * w8)
        for _inner in range(2):
            poses, disps = ba_step(target, weight, eta_frames, poses, disps, intrinsics, ii, jj,
                                   fixedp=fixedp, group=group)

        coords1, valid = pj.projective_transform(poses, disps, intrinsics, ii, jj)
        poses_list.append(poses)
        disps_list.append(upsample_disp(disps, upmask))
        residual_list.append(valid * (target - coords1))

    return poses_list, disps_list, residual_list
