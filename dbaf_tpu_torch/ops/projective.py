"""Projective camera operations: inverse projection, reprojection, flow.

Port of ``dbaf_tpu/ops/projective.py``: the SE3 and Sim3 reprojections
and their Jacobians, the motion-compensated reprojection and induced flow,
the frame distances, and the export's back-projection and depth vote.
Poses are world->camera 7-vectors (8-vectors for Sim3), disparities are
inverse depths at 1/8 resolution and intrinsics are ``[fx, fy, cx, cy]``
already divided by 8.  Edge-indexed functions take integer index tensors
``ii, jj`` and gather from the keyframe axis.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils.device import device_const
from . import lie, sim3

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
    """Per-edge G_ij with the fixed stereo baseline for ii == jj edges.
    SE3 7-vectors or Sim3 8-vectors (the training-time branch,
    projective_ops.py:84-94; the baseline lifts to unit scale)."""
    if poses.shape[-1] == 8:
        gij = sim3.rel(poses[ii], poses[jj])
        override = device_const(_STEREO_POSE + (1.0,), gij.dtype, gij.device)
    else:
        gij = lie.se3_rel(poses[ii], poses[jj])
        override = device_const(_STEREO_POSE, gij.dtype, gij.device)
    return torch.where((ii == jj)[..., None], override, gij)


def projective_transform(poses, disps, intrinsics, ii, jj, min_depth: float = MIN_DEPTH_PY,
                         return_depth: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reproject every pixel of frame ii into frame jj
    (projective_ops.py:96-125).  ``poses`` are (N, 7) SE3 or (N, 8) Sim3
    ``(t, q, s)``.  Returns coords (E, H, W, 2[+1]) and the validity mask
    (E, H, W, 1)."""
    intr_i, intr_j = _intrinsics_ij(intrinsics, ii, jj)
    X0 = iproj(disps[ii], intr_i)
    gij = _edge_rel_poses(poses, ii, jj)
    act4 = sim3.act4 if poses.shape[-1] == 8 else lie.se3_act4
    X1 = act4(gij[:, None, None, :], X0)
    coords = proj(X1, intr_j, min_depth=min_depth, return_depth=return_depth)
    valid = (X1[..., 2] > min_depth) & (X0[..., 2] > min_depth)
    return coords, valid[..., None].to(coords.dtype)


def projective_transform_comp(poses, disps, intrinsics, ii, jj, xyz_comp: torch.Tensor,
                              min_depth: float = MIN_DEPTH_PY) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`projective_transform` with an additive object-motion offset
    ``xyz_comp`` (E, H, W, 4) on the transformed homogeneous points before
    the projection (projective_ops.py:127-158)."""
    intr_i, intr_j = _intrinsics_ij(intrinsics, ii, jj)
    X0 = iproj(disps[ii], intr_i)
    gij = _edge_rel_poses(poses, ii, jj)
    act4 = sim3.act4 if poses.shape[-1] == 8 else lie.se3_act4
    X1 = act4(gij[:, None, None, :], X0) + xyz_comp
    coords = proj(X1, intr_j, min_depth=min_depth)
    valid = (X1[..., 2] > min_depth) & (X0[..., 2] > min_depth)
    return coords, valid[..., None].to(coords.dtype)


def induced_flow(poses, disps, intrinsics, ii, jj) -> Tuple[torch.Tensor, torch.Tensor]:
    """Optical flow induced by the camera motion, (E, H, W, 2), and the
    validity mask (projective_ops.py:160-171)."""
    ht, wd = disps.shape[-2:]
    coords0 = coords_grid(ht, wd, dtype=disps.dtype, device=disps.device)
    coords1, valid = projective_transform(poses, disps, intrinsics, ii, jj)
    return coords1[..., :2] - coords0, valid


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


def projection_jacobians_sim3(poses, disps, intrinsics, ii, jj,
                              min_depth: float = MIN_DEPTH_PY) -> EdgeJacobians:
    """7-dof reprojection Jacobians for Sim3 poses (N, 8), the Sim3 branch of
    the reference's training-time linearization (projective_ops.py:36-94):
    Ji, Jj are (E, H, W, 2, 7), their scale column exactly 0 (a pure
    scale of the relative Sim3 scales the point and leaves its projection);
    Ji applies the negated Sim3 dual adjoint row-wise, through which the
    frames' scales enter; Jz = Jp . Gij e4."""
    intr_i, intr_j = _intrinsics_ij(intrinsics, ii, jj)
    X0 = iproj(disps[ii], intr_i)
    gij = _edge_rel_poses(poses, ii, jj)
    gije = gij[:, None, None, :]
    X1 = sim3.act4(gije, X0)

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
            fx * (-x * y * d2), fx * (1.0 + x * x * d2), fx * (-y * d), o,
            o, fy * (h * d), fy * (-y * h * d2),
            fy * (-1.0 - y * y * d2), fy * (x * y * d2), fy * (x * d), o,
        ],
        dim=-1,
    ).reshape(x.shape + (2, 7))

    tx, ty, tz = (gij[:, k][:, None, None] for k in range(3))
    Jz = torch.stack(
        [fx * (tx * d - tz * (x * d2)), fy * (ty * d - tz * (y * d2))], dim=-1
    )
    Ji = -sim3.adjT(gije[..., None, :], Jj)
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


def iproj_points(poses: torch.Tensor, disps: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Back-project every keyframe pixel to a 3-D point for the export.
    ``poses`` are camera->world here (the caller inverts), as for the
    reference's ``iproj_kernel`` (droid_kernels.cu:824-895).  Returns
    (N, H, W, 3)."""
    X0 = iproj(disps, intrinsics.expand(disps.shape[:-2] + (4,)))
    X1 = lie.se3_act4(poses[:, None, None, :], X0)
    return X1[..., :3] / torch.clamp(X1[..., 3:4], min=1e-8)


# the neighbour frames of the depth vote, as the reference's
# depth_filter_kernel offsets them (droid_kernels.cu:740)
_VOTE_OFFSETS = (-1, -2, -3, 3, 4, 5)


def depth_consistency_count(poses: torch.Tensor, disps: torch.Tensor, intrinsics: torch.Tensor,
                            ix: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    """Multi-view depth-consistency votes that mask the exported points.

    Every pixel of keyframe ``ix[k]`` is reprojected into the six
    neighbours ``ix[k] + {-1, -2, -3, 3, 4, 5}`` that exist; a neighbour
    votes where the full 2x2 bilinear window lies in the image and any of
    its four taps agrees in inverse depth, ``|1/d_proj - 1/d_tap| <
    thresh[k]`` (droid_kernels.cu:706-820).  Returns (K, H, W) counts in
    the disparities' dtype."""
    offs = device_const(_VOTE_OFFSETS, torch.int64, disps.device)
    num = disps.shape[0]
    neighbors = ix[:, None] + offs[None, :]
    nvalid = (neighbors >= 0) & (neighbors < num)
    neighbors_c = torch.clamp(neighbors, 0, num - 1)
    K, J = neighbors.shape
    ht, wd = disps.shape[-2:]
    coords, _ = projective_transform(poses, disps, intrinsics, ix[:, None].expand(K, J).reshape(-1),
                                     neighbors_c.reshape(-1), return_depth=True)
    coords = coords.reshape(K, J, ht, wd, 3)
    x, y, dj = coords.unbind(-1)
    u0, v0 = torch.floor(x), torch.floor(y)
    inb = (u0 >= 0) & (v0 >= 0) & (u0 < wd - 1) & (v0 < ht - 1)
    u0i = torch.clamp(u0, 0, wd - 2).long()
    v0i = torch.clamp(v0, 0, ht - 2).long()
    nb = neighbors_c[:, :, None, None].expand_as(u0i)
    inv_dj = 1.0 / torch.clamp(dj, min=1e-8)
    th = thresh[:, None, None, None]
    agree = torch.zeros(dj.shape, dtype=torch.bool, device=disps.device)
    for dv in (0, 1):
        for du in (0, 1):
            d_tap = disps[nb, v0i + dv, u0i + du]
            agree = agree | (torch.abs(inv_dj - 1.0 / torch.clamp(d_tap, min=1e-8)) < th)
    vote = inb & agree & nvalid[:, :, None, None]
    return vote.sum(1).to(disps.dtype)
