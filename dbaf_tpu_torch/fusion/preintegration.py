"""IMU preintegration with bias Jacobians (CombinedImuFactor support).

Replaces the reference's use of GTSAM ``PreintegratedCombinedMeasurements``
(reference dbaf/multi_sensor.py:32-69, 86-103) with a self-contained
Forster-style manifold preintegration:

* deltas (dR, dv, dp) integrated in the frame of the first body pose;
* first-order bias-correction Jacobians (dR/dbg, dv/dba, dv/dbg, dp/dba,
  dp/dbg);
* 15x15 covariance over [theta, v, p, ba, bg] propagated discretely with
  accel/gyro white noise and bias random walk (the "combined" part);
* ``predict`` -- NavState propagation under gravity, used for pose seeding
  and high-rate output (multi_sensor.py:114-124, dbaf_frontend.py:222-228).

Host-side numpy f64: integration is inherently sequential per sample and
the arrays are tiny; the heavy visual system stays on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .se3np import Pose, hat, so3_exp, so3_right_jacobian

GRAVITY = 9.807  # multi_sensor.py:5


@dataclass
class ImuParams:
    accel_noise: float = 0.1
    gyro_noise: float = 0.01
    accel_walk: float = 1e-3
    gyro_walk: float = 1e-5
    gravity: float = GRAVITY
    # integration error covariance is zero in the reference
    # (multi_sensor.py:48)
    integration_noise: float = 0.0

    def loose(self, factor: float = 100.0) -> "ImuParams":
        """The 100x-looser variant used across IMU gaps
        (multi_sensor.py:62-69: covariances x100 = sigmas x10)."""
        return ImuParams(
            accel_noise=self.accel_noise * np.sqrt(factor),
            gyro_noise=self.gyro_noise * np.sqrt(factor),
            accel_walk=self.accel_walk,
            gyro_walk=self.gyro_walk,
            gravity=self.gravity,
        )

    @property
    def g_vec(self) -> np.ndarray:
        return np.array([0.0, 0.0, -self.gravity])


@dataclass
class NavState:
    pose: Pose
    vel: np.ndarray


class PreintegratedImu:
    """Accumulated IMU deltas between two keyframes."""

    def __init__(self, params: ImuParams, bias: Optional[np.ndarray] = None):
        self.params = params
        self.bias = np.zeros(6) if bias is None else np.asarray(bias, float)
        self.reset()

    def reset(self):
        self.dR = np.eye(3)
        self.dv = np.zeros(3)
        self.dp = np.zeros(3)
        self.dt = 0.0
        # bias jacobians
        self.dRg = np.zeros((3, 3))
        self.dvg = np.zeros((3, 3))
        self.dva = np.zeros((3, 3))
        self.dpg = np.zeros((3, 3))
        self.dpa = np.zeros((3, 3))
        # covariance over [theta, v, p, ba, bg]
        self.cov = np.zeros((15, 15))
        self.measurements: List[Tuple[np.ndarray, np.ndarray, float]] = []

    # ------------------------------------------------------------------
    def integrate(self, acc: np.ndarray, gyro: np.ndarray, dt: float):
        if dt <= 0:
            return
        acc = np.asarray(acc, float) - self.bias[:3]
        gyro = np.asarray(gyro, float) - self.bias[3:]
        self.measurements.append((acc + self.bias[:3], gyro + self.bias[3:], dt))

        dRk = so3_exp(gyro * dt)
        Jr = so3_right_jacobian(gyro * dt)
        R = self.dR
        acc_hat = hat(acc)

        # covariance propagation (error state [theta, v, p, ba, bg])
        A = np.eye(15)
        A[0:3, 0:3] = dRk.T
        A[3:6, 0:3] = -R @ acc_hat * dt
        A[6:9, 0:3] = -0.5 * R @ acc_hat * dt * dt
        A[6:9, 3:6] = np.eye(3) * dt
        A[3:6, 9:12] = -R * dt
        A[6:9, 9:12] = -0.5 * R * dt * dt
        A[0:3, 12:15] = -Jr * dt

        p = self.params
        Q = np.zeros((15, 15))
        Q[0:3, 0:3] = (Jr * dt) @ (Jr * dt).T * (p.gyro_noise**2 / dt)
        Q[3:6, 3:6] = (R * dt) @ (R * dt).T * (p.accel_noise**2 / dt)
        Q[6:9, 6:9] = np.eye(3) * (p.integration_noise**2) * dt
        Q[6:9, 3:6] = 0.5 * Q[3:6, 3:6] * dt
        Q[3:6, 6:9] = Q[6:9, 3:6].T
        Q[6:9, 6:9] += 0.25 * Q[3:6, 3:6] * dt * dt
        Q[9:12, 9:12] = np.eye(3) * (p.accel_walk**2) * dt
        Q[12:15, 12:15] = np.eye(3) * (p.gyro_walk**2) * dt
        self.cov = A @ self.cov @ A.T + Q

        # bias jacobians (Forster et al. eq. 44)
        self.dpa = self.dpa + self.dva * dt - 0.5 * R * dt * dt
        self.dpg = self.dpg + self.dvg * dt - 0.5 * R @ acc_hat @ self.dRg * dt * dt
        self.dva = self.dva - R * dt
        self.dvg = self.dvg - R @ acc_hat @ self.dRg * dt
        self.dRg = dRk.T @ self.dRg - Jr * dt

        # delta updates
        self.dp = self.dp + self.dv * dt + 0.5 * R @ acc * dt * dt
        self.dv = self.dv + R @ acc * dt
        self.dR = R @ dRk
        self.dt += dt

    # ------------------------------------------------------------------
    def corrected_deltas(self, bias: np.ndarray):
        """First-order bias-corrected deltas at a new bias estimate."""
        db_a = bias[:3] - self.bias[:3]
        db_g = bias[3:] - self.bias[3:]
        dR = self.dR @ so3_exp(self.dRg @ db_g)
        dv = self.dv + self.dva @ db_a + self.dvg @ db_g
        dp = self.dp + self.dpa @ db_a + self.dpg @ db_g
        return dR, dv, dp

    def predict(self, state: NavState, bias: np.ndarray) -> NavState:
        """NavState propagation (PreintegratedCombinedMeasurements::predict)."""
        dR, dv, dp = self.corrected_deltas(bias)
        Ri, pi, vi = state.pose.R, state.pose.t, state.vel
        g = self.params.g_vec
        Rj = Ri @ dR
        pj = pi + vi * self.dt + 0.5 * g * self.dt**2 + Ri @ dp
        vj = vi + g * self.dt + Ri @ dv
        return NavState(Pose(Rj, pj), vj)

    def reintegrate(self, params: ImuParams, bias: np.ndarray):
        """Re-run integration with new params/bias over stored measurements
        (the gap-handling path, multi_sensor.py:88-94)."""
        meas = self.measurements
        self.params = params
        self.bias = np.asarray(bias, float)
        self.reset()
        for acc, gyro, dt in meas:
            self.integrate(acc, gyro, dt)

    def noise_information(self) -> np.ndarray:
        """Information matrix over the 15-dim residual
        [theta, v, p, ba, bg] (regularized inverse of the covariance)."""
        cov = self.cov + np.eye(15) * 1e-12
        return np.linalg.inv(cov)
