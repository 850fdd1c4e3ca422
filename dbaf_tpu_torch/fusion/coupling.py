"""Camera-frame <-> body-frame Hessian conversion for the coupled solve.

The dense-BA reduced camera system is expressed in DROID's camera-frame
left-perturbation coordinates with [t, omega] ordering; the factor graph
uses body-frame right perturbations with [omega, t] ordering.  The
conversion is a per-pose linear map J (the reference's BA2GTSAM/GTSAM2BA,
pure-python form at reference dbaf/depth_video.py:20-29):

    J = rowswap(-Ad(Tbc^-1))       delta_cam = J @ delta_body
    H_body = J^T H_cam J,  v_body = J^T v_cam,  dx_cam = J @ dx_body
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from .factors import LinearContainerFactor, X
from .se3np import Pose


def ba2fg_block(Tbc: Pose) -> np.ndarray:
    """Per-pose 6x6 map J with delta_cam(droid) = J @ delta_body(fg)."""
    A = -Tbc.inverse().adjoint()  # fg ordering [omega, v]
    return np.vstack([A[3:6, :], A[0:3, :]])  # reorder to droid [t, omega]


def convert_hessian(
    H: np.ndarray, v: np.ndarray, Tbc: Pose
) -> Tuple[np.ndarray, np.ndarray]:
    """Camera-frame (S, v) -> body-frame (depth_video.py:20-29, BA2GTSAM)."""
    n = H.shape[0] // 6
    A = ba2fg_block(Tbc)
    J = np.kron(np.eye(n), A)
    return J.T @ H @ J, J.T @ v


def convert_dx(dx_body: np.ndarray, Tbc: Pose) -> np.ndarray:
    """Body-frame per-pose tangents -> DROID camera-frame dx (GTSAM2BA)."""
    n = len(dx_body) // 6
    A = ba2fg_block(Tbc)
    out = np.zeros_like(dx_body)
    for i in range(n):
        out[6 * i : 6 * i + 6] = A @ dx_body[6 * i : 6 * i + 6]
    return out


def hessian_factor(
    frame_ids: Sequence[int], poses: Dict, H: np.ndarray, v: np.ndarray
) -> LinearContainerFactor:
    """Wrap a body-frame (H, v) over window poses as a linear-container
    factor anchored at the given linearization point
    (CustomHessianFactor, depth_video.py:31-38)."""
    keys = [X(i) for i in frame_ids]
    lin_point = {X(i): poses[X(i)] for i in frame_ids}
    return LinearContainerFactor(keys, [6] * len(keys), H, v, lin_point)
