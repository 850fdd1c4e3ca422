"""Trajectory evaluation: Umeyama alignment + ATE RMSE.

Self-contained replacement for the reference's evo-based evaluation scripts
(reference evaluation_scripts/evaluate_tumvi.py:43-217): SE3 or Sim3
Umeyama alignment on a leading segment, then absolute trajectory error at
metric scale.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst.

    src, dst: (N, 3).  Returns (s, R, t) with dst ~= s * R @ src + t.
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def associate(
    t_est: np.ndarray, t_ref: np.ndarray, max_dt: float = 0.02
) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-timestamp association; returns index pairs (est, ref)."""
    idx_ref = np.searchsorted(t_ref, t_est)
    idx_ref = np.clip(idx_ref, 1, len(t_ref) - 1)
    left = t_ref[idx_ref - 1]
    right = t_ref[idx_ref]
    choose_left = (t_est - left) < (right - t_est)
    idx = np.where(choose_left, idx_ref - 1, idx_ref)
    ok = np.abs(t_ref[idx] - t_est) <= max_dt
    return np.nonzero(ok)[0], idx[ok]


def ate_rmse(
    est_pos: np.ndarray,
    ref_pos: np.ndarray,
    align: str = "sim3",
    align_n: Optional[int] = None,
) -> float:
    """ATE RMSE after aligning the first ``align_n`` poses (default: all).

    align: 'sim3' (scale+SE3, monocular) or 'se3' (metric-scale, the
    reference's post-init evaluation, evaluate_tumvi.py:173-178).
    """
    n = align_n or len(est_pos)
    s, R, t = umeyama(est_pos[:n], ref_pos[:n], with_scale=(align == "sim3"))
    aligned = est_pos @ (s * R).T + t
    err = np.linalg.norm(aligned - ref_pos, axis=1)
    return float(np.sqrt(np.mean(err**2)))


def evaluate_trajectory(
    est: np.ndarray,
    ref: np.ndarray,
    align: str = "sim3",
    max_dt: float = 0.02,
    align_n: Optional[int] = None,
) -> dict:
    """est, ref: (N, 8) rows [t, x, y, z, qx, qy, qz, qw]."""
    ei, ri = associate(est[:, 0], ref[:, 0], max_dt)
    if len(ei) < 3:
        return {"ate_rmse": float("inf"), "matched": int(len(ei))}
    rmse = ate_rmse(est[ei, 1:4], ref[ri, 1:4], align=align, align_n=align_n)
    return {"ate_rmse": rmse, "matched": int(len(ei))}
