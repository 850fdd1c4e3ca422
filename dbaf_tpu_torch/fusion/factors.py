"""Factor types for the multi-sensor graph (the GTSAM-fork replacement).

Implements the factor set the reference consumes from its GTSAM fork
(SURVEY.md 2.1 'GTSAM fork' row): CombinedImuFactor, GPSFactor with robust
Cauchy loss, the fork-added VelFactor (body-frame velocity), pose/bias
priors, BetweenFactorConstantBias, and the Hessian/linear-container factor
that couples the dense-BA reduced camera system into the graph
(reference dbaf/depth_video.py:31-38).

Conventions: Pose tangents are [omega, v] with right perturbation
(se3np.Pose); bias vectors are [ba, bg]; the IMU residual is 15-dim
[theta, v, p, ba, bg] ordered like the preintegration covariance.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .preintegration import PreintegratedImu
from .se3np import Pose, hat, so3_log, so3_right_jacobian_inv


# ---------------------------------------------------------------------------
# noise models
# ---------------------------------------------------------------------------

class Noise:
    """Gaussian noise with optional Cauchy robust reweighting."""

    def __init__(self, information: np.ndarray, cauchy_k: Optional[float] = None):
        self.information = np.asarray(information, float)
        self.cauchy_k = cauchy_k

    @staticmethod
    def sigmas(s, cauchy_k: Optional[float] = None) -> "Noise":
        s = np.asarray(s, float)
        return Noise(np.diag(1.0 / s**2), cauchy_k)

    @staticmethod
    def information(I, cauchy_k: Optional[float] = None) -> "Noise":
        return Noise(np.asarray(I, float), cauchy_k)

    def weighted(self, r: np.ndarray) -> Tuple[np.ndarray, float]:
        """Returns (effective information, scalar error contribution)."""
        Lam = self.information
        e2 = float(r @ Lam @ r)
        if self.cauchy_k is None:
            return Lam, 0.5 * e2
        k2 = self.cauchy_k**2
        w = k2 / (k2 + e2)
        rho = 0.5 * k2 * np.log1p(e2 / k2)
        return w * Lam, rho


# ---------------------------------------------------------------------------
# factor base
# ---------------------------------------------------------------------------

class Factor:
    keys: Tuple[str, ...]

    def error_and_jacobians(self, values) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        raise NotImplementedError

    def linearize(self, values):
        """-> (keys, blocks {key: J}, information, residual, error)."""
        r, J = self.error_and_jacobians(values)
        Lam, err = self.noise.weighted(r)
        return self.keys, J, Lam, r, err


# ---------------------------------------------------------------------------
# concrete factors
# ---------------------------------------------------------------------------

class PriorPose(Factor):
    """PriorFactorPose3: r = local(prior, T)."""

    def __init__(self, key: str, prior: Pose, noise: Noise):
        self.keys = (key,)
        self.prior = prior
        self.noise = noise

    def error_and_jacobians(self, values):
        T = values[self.keys[0]]
        M = self.prior.inverse().compose(T)
        r = Pose.logmap(M)
        # exact dr/d(xi): column-wise directional derivative of
        # Log(M Exp(xi)) -- six cheap expmap/logmap evaluations beat an
        # error-prone closed form at this (rare-factor) call rate
        J = np.zeros((6, 6))
        eps = 1e-7
        for k in range(6):
            d = np.zeros(6)
            d[k] = eps
            J[:, k] = (Pose.logmap(M.compose(Pose.expmap(d))) - r) / eps
        return r, {self.keys[0]: J}


class PriorVec(Factor):
    """Prior on a plain vector variable (velocity or bias)."""

    def __init__(self, key: str, prior: np.ndarray, noise: Noise):
        self.keys = (key,)
        self.prior = np.asarray(prior, float)
        self.noise = noise

    def error_and_jacobians(self, values):
        x = values[self.keys[0]]
        return x - self.prior, {self.keys[0]: np.eye(len(self.prior))}


class BetweenVec(Factor):
    """BetweenFactorConstantBias-style: r = (x_j - x_i) - measured."""

    def __init__(self, key_i: str, key_j: str, measured: np.ndarray, noise: Noise):
        self.keys = (key_i, key_j)
        self.measured = np.asarray(measured, float)
        self.noise = noise

    def error_and_jacobians(self, values):
        xi = values[self.keys[0]]
        xj = values[self.keys[1]]
        n = len(self.measured)
        return (xj - xi) - self.measured, {
            self.keys[0]: -np.eye(n),
            self.keys[1]: np.eye(n),
        }


class GPSFactor(Factor):
    """r = t(T) - p_measured (GPS position in world, lever arm handled by
    the caller as in depth_video.py:507-509)."""

    def __init__(self, key: str, position: np.ndarray, noise: Noise):
        self.keys = (key,)
        self.position = np.asarray(position, float)
        self.noise = noise

    def error_and_jacobians(self, values):
        T: Pose = values[self.keys[0]]
        r = T.t - self.position
        J = np.zeros((3, 6))
        J[:, 3:] = T.R  # d t / d v (right perturbation); d t / d omega = 0
        return r, {self.keys[0]: J}


class VelFactor(Factor):
    """Fork-added body-frame velocity factor (depth_video.py:517-521):
    r = R^T v_world - v_body_measured."""

    def __init__(self, pose_key: str, vel_key: str, v_body: np.ndarray, noise: Noise):
        self.keys = (pose_key, vel_key)
        self.v_body = np.asarray(v_body, float)
        self.noise = noise

    def error_and_jacobians(self, values):
        T: Pose = values[self.keys[0]]
        v = values[self.keys[1]]
        vb = T.R.T @ v
        r = vb - self.v_body
        Jp = np.zeros((3, 6))
        Jp[:, :3] = hat(vb)  # d(R Exp(w))^T v / dw = hat(R^T v)
        return r, {self.keys[0]: Jp, self.keys[1]: T.R.T}


class CombinedImuFactor(Factor):
    """Preintegrated IMU factor between consecutive states incl. bias
    random walk (the capability of gtsam.CombinedImuFactor used at
    depth_video.py:484-490).

    Residual (15): [r_theta, r_v, r_p, r_ba, r_bg] with
      r_theta = Log(dR(b)^T R_i^T R_j)
      r_v     = R_i^T (v_j - v_i - g dt) - dv(b)
      r_p     = R_i^T (p_j - p_i - v_i dt - 0.5 g dt^2) - dp(b)
      r_b     = b_j - b_i
    """

    def __init__(self, pose_i, vel_i, pose_j, vel_j, bias_i, bias_j,
                 pim: PreintegratedImu):
        self.keys = (pose_i, vel_i, pose_j, vel_j, bias_i, bias_j)
        self.pim = pim
        self.noise = Noise.information(pim.noise_information())

    def error_and_jacobians(self, values):
        Ti: Pose = values[self.keys[0]]
        vi = values[self.keys[1]]
        Tj: Pose = values[self.keys[2]]
        vj = values[self.keys[3]]
        bi = values[self.keys[4]]
        bj = values[self.keys[5]]

        pim = self.pim
        dt = pim.dt
        g = pim.params.g_vec
        dR, dv, dp = pim.corrected_deltas(bi)

        Ri, pi = Ti.R, Ti.t
        Rj, pj = Tj.R, Tj.t
        RiT = Ri.T

        Erot = dR.T @ RiT @ Rj
        r_th = so3_log(Erot)
        r_v = RiT @ (vj - vi - g * dt) - dv
        r_p = RiT @ (pj - pi - vi * dt - 0.5 * g * dt**2) - dp
        r_b = bj - bi
        r = np.concatenate([r_th, r_v, r_p, r_b])

        Jri = so3_right_jacobian_inv(r_th)

        # jacobians (Forster et al., right perturbations, [omega, v] order)
        Jpi = np.zeros((15, 6))
        Jpi[0:3, 0:3] = -Jri @ Rj.T @ Ri
        Jpi[3:6, 0:3] = hat(RiT @ (vj - vi - g * dt))
        Jpi[6:9, 0:3] = hat(RiT @ (pj - pi - vi * dt - 0.5 * g * dt**2))
        Jpi[6:9, 3:6] = -np.eye(3)

        Jvi = np.zeros((15, 3))
        Jvi[3:6] = -RiT
        Jvi[6:9] = -RiT * dt

        Jpj = np.zeros((15, 6))
        Jpj[0:3, 0:3] = Jri
        Jpj[6:9, 3:6] = RiT @ Rj

        Jvj = np.zeros((15, 3))
        Jvj[3:6] = RiT

        # bias_i: [ba, bg]; first-order rotation-bias coupling
        # d r_theta / d bg = -Jri * Exp(r_th)^T * dRg
        Jbi = np.zeros((15, 6))
        Jbi[0:3, 3:6] = -Jri @ Erot.T @ pim.dRg
        Jbi[3:6, 0:3] = -pim.dva
        Jbi[3:6, 3:6] = -pim.dvg
        Jbi[6:9, 0:3] = -pim.dpa
        Jbi[6:9, 3:6] = -pim.dpg
        Jbi[9:15, :] = -np.eye(6)

        Jbj = np.zeros((15, 6))
        Jbj[9:15, :] = np.eye(6)

        return r, {
            self.keys[0]: Jpi,
            self.keys[1]: Jvi,
            self.keys[2]: Jpj,
            self.keys[3]: Jvj,
            self.keys[4]: Jbi,
            self.keys[5]: Jbj,
        }


class LinearContainerFactor(Factor):
    """Gaussian information (H, v) anchored at a linearization point.

    Equivalent of gtsam.HessianFactor wrapped in a LinearContainerFactor
    (depth_video.py:31-38): at values x, contributes Hessian H and gradient
    ``v - H delta`` where ``delta = local(lin_point, x)``.
    """

    def __init__(self, keys: Sequence[str], dims: Sequence[int],
                 H: np.ndarray, v: np.ndarray, lin_point: Dict):
        self.keys = tuple(keys)
        self.dims = tuple(dims)
        self.H = np.asarray(H, float)
        self.v = np.asarray(v, float)
        self.lin_point = dict(lin_point)
        self.noise = None  # handled specially by the graph

    def delta(self, values) -> np.ndarray:
        parts = []
        for k in self.keys:
            x0 = self.lin_point[k]
            x = values[k]
            if isinstance(x0, Pose):
                parts.append(x0.local(x))
            else:
                parts.append(np.asarray(x, float) - np.asarray(x0, float))
        return np.concatenate(parts)

    def quadratic(self, values) -> Tuple[np.ndarray, np.ndarray, float]:
        """-> (H, b, error) at the current values."""
        d = self.delta(values)
        b = self.v - self.H @ d
        err = 0.5 * d @ self.H @ d - self.v @ d
        return self.H, b, err

    def rekey(self, mapping: Dict[str, str]) -> "LinearContainerFactor":
        keys = tuple(mapping.get(k, k) for k in self.keys)
        lp = {mapping.get(k, k): v for k, v in self.lin_point.items()}
        return LinearContainerFactor(keys, self.dims, self.H, self.v, lp)


# key helpers (symbol_shorthand X/V/B)
def X(i: int) -> str:
    return f"x{i}"


def V(i: int) -> str:
    return f"v{i}"


def B(i: int) -> str:
    return f"b{i}"
