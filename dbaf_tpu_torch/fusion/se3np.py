"""f64 SO(3)/SE(3) helpers in the factor-graph convention.

The factor-graph layer (the GTSAM replacement) uses:

* rotation matrices + translation vectors (not quaternions);
* tangent ordering ``[omega, v]`` (rotation first) -- GTSAM's Pose3
  convention, which the reference couples to via its BA2GTSAM reordering
  (reference dbaf/depth_video.py:20-29);
* right (body-frame) perturbations: ``retract(T, xi) = T @ Exp(xi)`` and
  ``local(T0, T1) = Log(T0^-1 @ T1)`` (matching the use at
  depth_video.py:551).

Everything is float64 numpy: the window graph is tiny (<= ~25 poses), so
the solve runs at reference precision (Eigen/GTSAM f64) with zero device
round trips.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-12


def hat(w: np.ndarray) -> np.ndarray:
    return np.array(
        [[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]]
    )


def so3_exp(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    W = hat(w)
    if th < 1e-10:
        return np.eye(3) + W + 0.5 * W @ W
    return (
        np.eye(3)
        + (np.sin(th) / th) * W
        + ((1.0 - np.cos(th)) / th**2) * W @ W
    )


def so3_log(R: np.ndarray) -> np.ndarray:
    tr = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(tr)
    if th < 1e-10:
        w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        return w
    if np.pi - th < 1e-6:
        # near pi: use the symmetric part
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        # fix signs from off-diagonals
        if axis[0] > 0:
            axis[1] = np.copysign(axis[1], A[0, 1])
            axis[2] = np.copysign(axis[2], A[0, 2])
        elif axis[1] > 0:
            axis[2] = np.copysign(axis[2], A[1, 2])
        return th * axis / max(np.linalg.norm(axis), _EPS)
    return (
        0.5
        * th
        / np.sin(th)
        * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    )


def so3_right_jacobian(w: np.ndarray) -> np.ndarray:
    """Jr(w): Exp(w + dw) ~ Exp(w) Exp(Jr dw)."""
    th = np.linalg.norm(w)
    W = hat(w)
    if th < 1e-8:
        return np.eye(3) - 0.5 * W + (1.0 / 6.0) * W @ W
    return (
        np.eye(3)
        - ((1.0 - np.cos(th)) / th**2) * W
        + ((th - np.sin(th)) / th**3) * W @ W
    )


def so3_right_jacobian_inv(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    W = hat(w)
    if th < 1e-8:
        return np.eye(3) + 0.5 * W + (1.0 / 12.0) * W @ W
    return (
        np.eye(3)
        + 0.5 * W
        + (1.0 / th**2 - (1.0 + np.cos(th)) / (2.0 * th * np.sin(th))) * W @ W
    )


class Pose:
    """Rigid transform (R, t) with GTSAM-style [omega, v] tangent."""

    __slots__ = ("R", "t")

    def __init__(self, R=None, t=None):
        self.R = np.eye(3) if R is None else np.asarray(R, dtype=np.float64)
        self.t = np.zeros(3) if t is None else np.asarray(t, dtype=np.float64)

    def compose(self, other: "Pose") -> "Pose":
        return Pose(self.R @ other.R, self.R @ other.t + self.t)

    def inverse(self) -> "Pose":
        Rt = self.R.T
        return Pose(Rt, -Rt @ self.t)

    def matrix(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = self.R
        T[:3, 3] = self.t
        return T

    @staticmethod
    def from_matrix(T: np.ndarray) -> "Pose":
        return Pose(T[:3, :3], T[:3, 3])

    @staticmethod
    def expmap(xi: np.ndarray) -> "Pose":
        """SE(3) exponential, xi = [omega, v]."""
        w, v = xi[:3], xi[3:]
        R = so3_exp(w)
        th = np.linalg.norm(w)
        W = hat(w)
        if th < 1e-8:
            V = np.eye(3) + 0.5 * W + (1.0 / 6.0) * W @ W
        else:
            V = (
                np.eye(3)
                + ((1.0 - np.cos(th)) / th**2) * W
                + ((th - np.sin(th)) / th**3) * W @ W
            )
        return Pose(R, V @ v)

    @staticmethod
    def logmap(T: "Pose") -> np.ndarray:
        w = so3_log(T.R)
        th = np.linalg.norm(w)
        W = hat(w)
        if th < 1e-8:
            Vinv = np.eye(3) - 0.5 * W + (1.0 / 12.0) * W @ W
        else:
            Vinv = (
                np.eye(3)
                - 0.5 * W
                + (1.0 / th**2 - (1.0 + np.cos(th)) / (2.0 * th * np.sin(th)))
                * W
                @ W
            )
        return np.concatenate([w, Vinv @ T.t])

    def retract(self, xi: np.ndarray) -> "Pose":
        return self.compose(Pose.expmap(xi))

    def local(self, other: "Pose") -> np.ndarray:
        return Pose.logmap(self.inverse().compose(other))

    def adjoint(self) -> np.ndarray:
        """Ad_T for [omega, v] ordering: [[R, 0], [t^ R, R]]."""
        A = np.zeros((6, 6))
        A[:3, :3] = self.R
        A[3:, 3:] = self.R
        A[3:, :3] = hat(self.t) @ self.R
        return A
