"""Per-keyframe IMU-centered state stream.

Port of the semantics of reference dbaf/multi_sensor.py:7-155 onto the
native fusion primitives: IMU-rate integration between keyframes with gap
handling (gaps > 0.025 s rebuild the preintegration with 100x-looser noise),
NavState propagation per image (reset if the gap exceeds 1 s), +-0.01 s
sync-gated GNSS/odometry attachment, and a high-frequency temp
preintegration for IMU-rate pose output.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..fusion.preintegration import ImuParams, NavState, PreintegratedImu
from ..fusion.se3np import Pose


class MultiSensorState:
    def __init__(self, params: Optional[ImuParams] = None):
        self.params = params or ImuParams()
        self.params_loose = self.params.loose()
        self.cur_t = 0.0

        self.timestamps: List[float] = []
        self.wTbs: List[Pose] = []
        self.vs: List[np.ndarray] = []
        self.bs: List[np.ndarray] = []  # [ba, bg]
        self.preintegrations: List[PreintegratedImu] = []
        self.preintegrations_meas: List[list] = []
        self.preintegration_temp: Optional[PreintegratedImu] = None
        self.pose_temp: Optional[NavState] = None

        self.gnss_valid: List[bool] = []
        self.gnss_position: List[np.ndarray] = []
        self.odo_valid: List[bool] = []
        self.odo_vel: List[np.ndarray] = []

    def set_imu_params(self, noise=None):
        """(accel_noise, gyro_noise, accel_walk, gyro_walk) sigmas."""
        if noise is not None:
            self.params = ImuParams(
                accel_noise=noise[0], gyro_noise=noise[1],
                accel_walk=noise[2], gyro_walk=noise[3],
            )
            self.params_loose = self.params.loose()

    # ------------------------------------------------------------------
    def init_first_state(self, t, pos, R, vel):
        self.timestamps.append(t)
        self.wTbs.append(Pose(R, pos))
        self.vs.append(np.asarray(vel, float))
        self.bs.append(np.zeros(6))
        self.preintegrations.append(PreintegratedImu(self.params, self.bs[-1]))
        self.preintegrations_meas.append([])
        self.preintegration_temp = PreintegratedImu(self.params, self.bs[-1])
        self.gnss_valid.append(False)
        self.gnss_position.append(np.zeros(3))
        self.odo_valid.append(False)
        self.odo_vel.append(np.zeros(3))
        self.cur_t = t

    def append_imu(self, t, acc, gyro):
        dt = t - self.cur_t
        if dt > 0:
            if dt > 0.025:
                # IMU gap: rebuild this interval with loose noise
                # (multi_sensor.py:88-94)
                pim = PreintegratedImu(self.params_loose, self.bs[-1])
                for a, g, d, _ in self.preintegrations_meas[-1]:
                    if d > 0:
                        pim.integrate(a, g, d)
                self.preintegrations[-1] = pim
            self.preintegrations[-1].integrate(acc, gyro, dt)
        if dt < 0:
            raise ValueError("IMU timestamps must be non-decreasing")
        self.preintegrations_meas[-1].append(
            [np.asarray(acc, float), np.asarray(gyro, float), dt, t]
        )
        self.cur_t = t

    def append_imu_temp(self, t, acc, gyro, predict_pose=False):
        if t - self.cur_t > 0:
            self.preintegration_temp.integrate(acc, gyro, t - self.cur_t)
        if predict_pose:
            prev = NavState(self.wTbs[-1], self.vs[-1])
            self.pose_temp = self.preintegration_temp.predict(prev, self.bs[-1])

    def append_img(self, t):
        self.cur_t = t
        prev = NavState(self.wTbs[-1], self.vs[-1])
        prop = self.preintegrations[-1].predict(prev, self.bs[-1])
        if self.preintegrations[-1].dt > 1.0:
            prop = prev  # reset on long gaps (multi_sensor.py:119-120)

        self.timestamps.append(t)
        self.wTbs.append(prop.pose)
        self.vs.append(prop.vel)
        self.bs.append(self.bs[-1].copy())
        self.gnss_valid.append(False)
        self.gnss_position.append(np.zeros(3))
        self.odo_valid.append(False)
        self.odo_vel.append(np.zeros(3))
        self.preintegrations.append(PreintegratedImu(self.params, self.bs[-1]))
        self.preintegrations_meas.append([])
        self.preintegration_temp = PreintegratedImu(self.params, self.bs[-1])

    def append_gnss(self, t, pos):
        if abs(self.cur_t - t) > 0.01:
            return False
        self.gnss_valid[-1] = True
        self.gnss_position[-1] = np.asarray(pos, float)
        return True

    def append_odo(self, t, vel):
        if abs(self.cur_t - t) > 0.01:
            return False
        self.odo_valid[-1] = True
        self.odo_vel[-1] = np.asarray(vel, float)
        return True

    # ------------------------------------------------------------------
    def merge_keyframe(self, idx: int):
        """Merge preintegration[idx] into [idx-1] when keyframe idx is
        culled (dbaf_frontend.py:328-353).

        List deletion generalizes the reference's slot-swap (which assumes
        the culled frame is the second-newest); the async coupled pipeline
        mirrors culls with a one-step lag, by which time one more frame
        has been appended."""
        for dd in self.preintegrations_meas[idx]:
            if dd[2] > 0:
                self.preintegrations[idx - 1].integrate(dd[0], dd[1], dd[2])
            self.preintegrations_meas[idx - 1].append(dd)
        del self.preintegrations[idx]
        del self.preintegrations_meas[idx]
        for lst in (self.wTbs, self.bs, self.vs, self.gnss_valid,
                    self.gnss_position, self.odo_valid, self.odo_vel,
                    self.timestamps):
            del lst[idx]

    def rollup(self, roll: int):
        """Drop the first ``roll`` states (dbaf_frontend.py:143-151)."""
        for name in ("timestamps", "wTbs", "vs", "bs", "preintegrations",
                     "preintegrations_meas", "gnss_valid", "gnss_position",
                     "odo_valid", "odo_vel"):
            setattr(self, name, getattr(self, name)[roll:])

    def __len__(self):
        return len(self.timestamps)
