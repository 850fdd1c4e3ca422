"""Plain camera and trajectory geometry, written from the formulas.

* :func:`reproject`: every pixel of frame ``i`` at its inverse depth, moved
  by ``G_j G_i^-1`` into frame ``j`` and projected (the pinhole model of
  DROID-SLAM's ``projective_ops.py``: a point is valid where the third
  coordinate of the moved homogeneous point is above 0.2).  The
  benchmark's oracle uses it.
* :func:`align_rigid`: the rotation that best maps one set of
  orientations onto another (the polar factor of their summed products),
  and the translation that then best maps the positions.
* :func:`trajectory_errors`: an estimated body trajectory against the
  scene's ground truth.

Poses are 7-vectors ``[t, qx, qy, qz, qw]``.  Nothing here comes from the
program.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

MIN_DEPTH = 0.2


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) of unit quaternions (..., 4) ``[x, y, z, w]``."""
    x, y, z, w = q.unbind(-1)
    m = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                     2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return m.reshape(q.shape[:-1] + (3, 3))


def reproject(poses_cw: torch.Tensor, disps: torch.Tensor, intr: torch.Tensor,
              ii: torch.Tensor, jj: torch.Tensor):
    """Pixel coordinates (E, H, W, 2) in frame ``jj`` of every pixel of frame
    ``ii``, and their validity (E, H, W, 1); world-to-camera poses (N, 7),
    inverse depths (N, H, W), intrinsics ``[fx, fy, cx, cy]``."""
    fx, fy, cx, cy = intr.unbind(-1)
    H, W = disps.shape[-2:]
    v, u = torch.meshgrid(torch.arange(H, dtype=disps.dtype, device=disps.device),
                          torch.arange(W, dtype=disps.dtype, device=disps.device), indexing="ij")
    ray = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)  # (H, W, 3)
    Ri, ti = quat_to_matrix(poses_cw[ii, 3:]), poses_cw[ii, :3]
    Rj, tj = quat_to_matrix(poses_cw[jj, 3:]), poses_cw[jj, :3]
    R = Rj @ Ri.transpose(-1, -2)  # G_ij = G_j G_i^-1
    t = tj - (R @ ti[..., None])[..., 0]
    d = disps[ii][..., None]  # (E, H, W, 1)
    # the homogeneous point (ray, d) of depth 1/d in frame i, moved: R ray + t d
    X = torch.einsum("eab,hwb->ehwa", R, ray) + t[:, None, None, :] * d
    Z = X[..., 2:3]
    Zs = torch.where(Z < 0.5 * MIN_DEPTH, torch.ones_like(Z), Z)
    coords = torch.cat([fx * X[..., 0:1] / Zs + cx, fy * X[..., 1:2] / Zs + cy], -1)
    valid = Z > MIN_DEPTH
    return coords, valid.to(coords.dtype)


def align_rigid(src_R: np.ndarray, src_p: np.ndarray, dst_R: np.ndarray, dst_p: np.ndarray):
    """(R, t) with R maximising sum tr(R src_R_k dst_R_k^T) over rotations
    (N, 3, 3), and t minimising sum |R src_p_k + t - dst_p_k|^2."""
    U, _, Vt = np.linalg.svd(np.einsum("nij,nkj->ik", dst_R, src_R))
    S = np.eye(3)
    S[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ S @ Vt
    return R, (dst_p - src_p @ R.T).mean(0)


def _matrix_of(q: np.ndarray) -> np.ndarray:
    return quat_to_matrix(torch.as_tensor(q, dtype=torch.float64)).numpy()


def row_errors(est: np.ndarray, gt_R: np.ndarray, gt_p: np.ndarray,
               est_ecef: Optional[np.ndarray] = None, gt_ecef: Optional[np.ndarray] = None):
    """Each row's position error (metres) and orientation error (degrees)
    after the rigid alignment (:func:`align_rigid`), and its ECEF distance
    with no alignment where both ECEF tracks (N, 3) are given (else None)."""
    est = np.asarray(est, np.float64)
    est_R = _matrix_of(est[:, 3:] / np.linalg.norm(est[:, 3:], axis=-1, keepdims=True))
    R, t = align_rigid(est_R, est[:, :3], gt_R, gt_p)
    dp = np.linalg.norm(est[:, :3] @ R.T + t - gt_p, axis=-1)
    cosang = (np.einsum("nij,nij->n", R @ est_R, gt_R) - 1.0) / 2.0
    ang = np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))
    ecef = None
    if est_ecef is not None and gt_ecef is not None:
        ecef = np.linalg.norm(np.asarray(est_ecef, np.float64) - gt_ecef, axis=-1)
    return dp, ang, ecef


def trajectory_errors(est: np.ndarray, gt_R: np.ndarray, gt_p: np.ndarray,
                      est_ecef: Optional[np.ndarray] = None,
                      gt_ecef: Optional[np.ndarray] = None) -> Dict[str, float]:
    """An estimated body trajectory (N, 7) against the truth (N, 3, 3) and
    (N, 3), from :func:`row_errors`:

    * ``traj_m``: the root mean square of the position errors, metres;
    * ``traj_deg``: the root mean square of the orientation errors, degrees;
    * ``ecef_m`` where both ECEF position tracks are given: the largest
      distance between them, metres.
    """
    dp, ang, ecef = row_errors(est, gt_R, gt_p, est_ecef, gt_ecef)
    out = dict(traj_m=float(np.sqrt(np.mean(dp ** 2))), traj_deg=float(np.sqrt(np.mean(ang ** 2))))
    if ecef is not None:
        out["ecef_m"] = float(np.max(ecef))
    return out
