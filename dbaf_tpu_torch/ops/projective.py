"""Projective camera operations: inverse projection, reprojection, flow.

Port of ``dbaf_tpu/ops/projective.py`` (SE3 paths).  Poses are
world->camera 7-vectors, disparities are inverse depths at 1/8 resolution
and intrinsics are ``[fx, fy, cx, cy]`` already divided by 8.  Edge-indexed
functions take integer index tensors ``ii, jj`` and gather from the
keyframe axis.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils.device import device_const
from . import lie

MIN_DEPTH_PY = 0.2
MIN_DEPTH_KERNEL = 0.25

_STEREO_POSE = (-0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0)


def coords_grid(ht: int, wd: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Pixel-center coordinate grid, shape (ht, wd, 2) ordered (x, y)."""
    y = torch.arange(ht, dtype=dtype, device=device)
    x = torch.arange(wd, dtype=dtype, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def iproj(disps: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """disps (..., H, W), intrinsics (..., 4) -> points (..., H, W, 4) as
    ``((u-cx)/fx, (v-cy)/fy, 1, disp)``."""
    ht, wd = disps.shape[-2], disps.shape[-1]
    fx, fy, cx, cy = intrinsics[..., None, None, :].unbind(-1)
    grid = coords_grid(ht, wd, dtype=disps.dtype, device=disps.device)
    X = (grid[..., 0] - cx) / fx
    Y = (grid[..., 1] - cy) / fy
    X, Y = torch.broadcast_tensors(X, Y)
    X = X.expand(disps.shape)
    Y = Y.expand(disps.shape)
    return torch.stack([X, Y, torch.ones_like(disps), disps], dim=-1)


def proj(Xs: torch.Tensor, intrinsics: torch.Tensor, min_depth: float = MIN_DEPTH_PY,
         return_depth: bool = False) -> torch.Tensor:
    """Pinhole projection of homogeneous-depth points (..., H, W, 4)."""
    fx, fy, cx, cy = intrinsics[..., None, None, :].unbind(-1)
    X, Y, Z, D = Xs.unbind(-1)
    Z = torch.where(Z < 0.5 * min_depth, torch.ones_like(Z), Z)
    d = 1.0 / Z
    x = fx * X * d + cx
    y = fy * Y * d + cy
    if return_depth:
        return torch.stack([x, y, D * d], dim=-1)
    return torch.stack([x, y], dim=-1)


def _intrinsics_ij(intrinsics, ii, jj):
    if intrinsics.ndim == 1:
        e = intrinsics.expand(ii.shape + (4,))
        return e, e
    return intrinsics[ii], intrinsics[jj]


def _edge_rel_poses(poses: torch.Tensor, ii: torch.Tensor, jj: torch.Tensor) -> torch.Tensor:
    """Per-edge G_ij with the fixed stereo baseline for ii == jj edges."""
    gij = lie.se3_rel(poses[ii], poses[jj])
    override = device_const(_STEREO_POSE, gij.dtype, gij.device)
    return torch.where((ii == jj)[..., None], override, gij)


def projective_transform(poses, disps, intrinsics, ii, jj, min_depth: float = MIN_DEPTH_PY,
                         return_depth: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reproject every pixel of frame ii into frame jj
    (projective_ops.py:96-125).  Returns coords (E, H, W, 2[+1]) and the
    validity mask (E, H, W, 1)."""
    intr_i, intr_j = _intrinsics_ij(intrinsics, ii, jj)
    X0 = iproj(disps[ii], intr_i)
    gij = _edge_rel_poses(poses, ii, jj)
    X1 = lie.se3_act4(gij[:, None, None, :], X0)
    coords = proj(X1, intr_j, min_depth=min_depth, return_depth=return_depth)
    valid = (X1[..., 2] > min_depth) & (X0[..., 2] > min_depth)
    return coords, valid[..., None].to(coords.dtype)


class EdgeJacobians(NamedTuple):
    coords: torch.Tensor  # (E, H, W, 2)
    valid: torch.Tensor   # (E, H, W) bool
    Ji: torch.Tensor      # (E, H, W, 2, 6)
    Jj: torch.Tensor      # (E, H, W, 2, 6)
    Jz: torch.Tensor      # (E, H, W, 2)


def projection_jacobians(poses, disps, intrinsics, ii, jj,
                         min_depth: float = MIN_DEPTH_KERNEL) -> EdgeJacobians:
    """Analytic reprojection Jacobians of the reference DBA kernel
    (droid_kernels.cu:325-419); ``d`` is zeroed at invalid depth so invalid
    pixels contribute exact zeros."""
    intr_i, intr_j = _intrinsics_ij(intrinsics, ii, jj)
    X0 = iproj(disps[ii], intr_i)
    gij = _edge_rel_poses(poses, ii, jj)
    gije = gij[:, None, None, :]
    X1 = lie.se3_act4(gije, X0)

    x, y, z, h = X1.unbind(-1)
    valid = z > min_depth
    d = torch.where(valid, 1.0 / torch.where(valid, z, torch.ones_like(z)), torch.zeros_like(z))
    d2 = d * d

    fx, fy, cx, cy = intr_j[:, None, None, :].unbind(-1)
    coords = torch.stack([fx * d * x + cx, fy * d * y + cy], dim=-1)

    o = torch.zeros_like(d)
    Jj = torch.stack(
        [
            fx * (h * d), o, fx * (-x * h * d2),
            fx * (-x * y * d2), fx * (1.0 + x * x * d2), fx * (-y * d),
            o, fy * (h * d), fy * (-y * h * d2),
            fy * (-1.0 - y * y * d2), fy * (x * y * d2), fy * (x * d),
        ],
        dim=-1,
    ).reshape(x.shape + (2, 6))

    tx, ty, tz = (gij[:, k][:, None, None] for k in range(3))
    Jz = torch.stack(
        [fx * (tx * d - tz * (x * d2)), fy * (ty * d - tz * (y * d2))], dim=-1
    )
    Ji = -lie.se3_adjT(gije[..., None, :], Jj)
    return EdgeJacobians(coords=coords, valid=valid, Ji=Ji, Jj=Jj, Jz=Jz)


def frame_distance(poses, disps, intrinsics, ii, jj, beta: float = 0.3,
                   min_depth: float = MIN_DEPTH_KERNEL) -> torch.Tensor:
    """Mean reprojection-flow distance, full-SE3 and translation-only flow
    blended by ``beta``; 1000 when fewer than 75% of pixels are valid
    (droid_kernels.cu:562-702).  intrinsics: (4,)."""
    ht, wd = disps.shape[-2:]
    grid = coords_grid(ht, wd, dtype=disps.dtype, device=disps.device)
    X0 = iproj(disps[ii], intrinsics.expand(ii.shape + (4,)))
    gij = lie.se3_rel(poses[ii], poses[jj])

    X1 = lie.se3_act4(gij[:, None, None, :], X0)
    fx, fy, cx, cy = intrinsics.unbind(-1)
    du = fx * (X1[..., 0] / X1[..., 2]) + cx - grid[..., 0]
    dv = fy * (X1[..., 1] / X1[..., 2]) + cy - grid[..., 1]
    d_full = torch.sqrt(du * du + dv * dv)
    valid_full = X1[..., 2] > min_depth

    t = gij[:, None, None, :3]
    Xt = X0[..., :3] + X0[..., 3:4] * t
    du = fx * (Xt[..., 0] / Xt[..., 2]) + cx - grid[..., 0]
    dv = fy * (Xt[..., 1] / Xt[..., 2]) + cy - grid[..., 1]
    d_trans = torch.sqrt(du * du + dv * dv)
    valid_trans = Xt[..., 2] > min_depth

    zero = torch.zeros((), dtype=disps.dtype, device=disps.device)
    accum = beta * torch.sum(torch.where(valid_full, d_full, zero), dim=(-2, -1)) + (
        1.0 - beta
    ) * torch.sum(torch.where(valid_trans, d_trans, zero), dim=(-2, -1))
    valid = beta * torch.sum(valid_full, dim=(-2, -1)) + (1.0 - beta) * torch.sum(
        valid_trans, dim=(-2, -1)
    )
    frac = valid / (float(ht * wd) + 1e-8)
    dist = accum / torch.clamp(valid, min=1e-8)
    return torch.where(frac < 0.75, torch.full_like(dist, 1000.0), dist)


def frame_distance_bidirectional(poses, disps, intrinsics, ii, jj, beta: float = 0.3) -> torch.Tensor:
    """0.5 * (d(ii->jj) + d(jj->ii)) (depth_video.py:251-261)."""
    d1 = frame_distance(poses, disps, intrinsics, ii, jj, beta)
    d2 = frame_distance(poses, disps, intrinsics, jj, ii, beta)
    return 0.5 * (d1 + d2)
