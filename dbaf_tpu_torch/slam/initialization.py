"""Visual-inertial / GNSS initialization suite (port of
``dbaf_tpu/slam/initialization.py``; host numpy f64 apart from one pose
read and one pose write on the device per alignment).

Semantics of the reference's initialization chain
(dbaf_frontend.py:377-814): IMU state bootstrap with
the pose-perturbation trick, VINS-Mono-style visual-IMU alignment
(gyroscope-bias solve -> linear scale/gravity/velocity alignment -> gravity
refinement on the tangent basis -> state rewrite), and GNSS heading/scale
georeferencing once the baseline exceeds 10 m.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..fusion.factors import B, CombinedImuFactor, V, X
from ..fusion.graph import Values
from ..fusion.se3np import Pose
from ..ops import lie_np
from ..utils import geodesy
from ..utils.device import to_host
from .coupled import MultiSensorBA
from .video import DepthVideo


def body_poses_from_video(
    video: DepthVideo, Tbc: Pose, t1: int, ignore_lever: bool
) -> np.ndarray:
    """wTb 4x4 matrices for frames [0, t1) from the camera pose buffer:
    one device read, all pose algebra in host numpy (lie_np)."""
    poses = to_host(video.poses[:t1]).astype(np.float64)
    wTcs = lie_np.se3_matrix(lie_np.se3_inv(poses))
    Tcb = Tbc.inverse().matrix()
    if ignore_lever:
        Tcb = Tcb.copy()
        Tcb[0:3, 3] = 0.0
    return np.matmul(wTcs, Tcb)


def write_camera_poses(
    video: DepthVideo, wTbs: np.ndarray, Tbc: Pose, t1: int,
    scale: Optional[float] = None, ignore_lever: bool = False,
):
    """Write body poses back as camera Tcw 7-vectors; optionally rescale
    disparities (dbaf_frontend.py:806-814)."""
    Tbc_m = Tbc.matrix()
    if ignore_lever:
        Tbc_m = Tbc_m.copy()
        Tbc_m[0:3, 3] = 0.0
    wTcs = np.matmul(wTbs[:t1], Tbc_m)
    new_poses = lie_np.se3_from_matrix(np.linalg.inv(wTcs))
    video.set_poses_range(0, new_poses.astype(np.float32))
    if scale is not None and scale > 0:
        video.scale_disps(t1, float(scale))


def init_imu_states(
    frontend, all_imu: np.ndarray, all_gnss: np.ndarray, all_odo: np.ndarray
):
    """Bootstrap the MultiSensorState from raw IMU between keyframe stamps
    and seed perturbed camera poses (dbaf_frontend.py:377-432).

    all_imu rows: [t, gx, gy, gz (deg/s), ax, ay, az]; gnss/odo rows:
    [t, x, y, z].
    """
    import bisect

    video = frontend.video
    coupled: MultiSensorBA = frontend.graph.coupled
    state = coupled.state
    t0, t1 = frontend.t0, frontend.t1

    cur_t = float(video.tstamp[t0])
    k = 0
    while all_imu[k][0] < cur_t - 1e-6:
        k += 1
    frontend.cur_imu_ii = k

    for i in range(t0, t1):
        if i == t0:
            state.init_first_state(cur_t, np.zeros(3), np.eye(3), np.zeros(3))
            imu = all_imu[frontend.cur_imu_ii]
            state.append_imu(imu[0], imu[4:7], np.deg2rad(imu[1:4]))
            frontend.cur_imu_ii += 1
        else:
            cur_t = float(video.tstamp[i])
            while all_imu[frontend.cur_imu_ii][0] < cur_t:
                imu = all_imu[frontend.cur_imu_ii]
                state.append_imu(imu[0], imu[4:7], np.deg2rad(imu[1:4]))
                frontend.cur_imu_ii += 1
            imu = all_imu[frontend.cur_imu_ii]
            state.append_imu(cur_t, imu[4:7], np.deg2rad(imu[1:4]))
            state.append_img(cur_t)

            if len(all_gnss) > 0:
                g = bisect.bisect(list(all_gnss[:, 0]), cur_t - 1e-6)
                if 0 < g < len(all_gnss) and all_gnss[g, 0] - cur_t < 0.01:
                    state.append_gnss(cur_t, all_gnss[g, 1:4])
            if len(all_odo) > 0:
                o = bisect.bisect(list(all_odo[:, 0]), cur_t - 1e-6)
                if 0 < o < len(all_odo) and all_odo[o, 0] - cur_t < 0.01:
                    state.append_odo(cur_t, all_odo[o, 1:4])

            imu = all_imu[frontend.cur_imu_ii]
            state.append_imu(imu[0], imu[4:7], np.deg2rad(imu[1:4]))
            frontend.cur_imu_ii += 1

        # perturbed camera pose seed (dbaf_frontend.py:424-431)
        if not video.imu_enabled:
            Tz = np.eye(4)
            Tz[2, 3] = 0.02 * i
            Twc = Tz @ coupled.Tbc.matrix()
            Tcw = np.linalg.inv(Twc)
            video.set_pose(
                i, torch.as_tensor(lie_np.se3_from_matrix(Tcw), dtype=torch.float32)
            )


def visual_imu_alignment(
    video: DepthVideo, coupled: MultiSensorBA, t0: int, t1: int,
    ignore_lever: bool, disable_scale: bool = False,
) -> Tuple[float, np.ndarray]:
    """VINS-Mono-style alignment (dbaf_frontend.py:606-814).

    Returns (scale, gravity_world) after rewriting poses/velocities/biases
    and disparities.
    """
    state = coupled.state
    wTbs = body_poses_from_video(video, coupled.Tbc, t1, ignore_lever)

    # --- solveGyroscopeBias (dbaf_frontend.py:619-651)
    A = np.zeros((3, 3))
    b = np.zeros(3)
    for i in range(t0, t1 - 1):
        f = CombinedImuFactor(X(0), V(0), X(1), V(1), B(0), B(1),
                              state.preintegrations[i])
        vals = Values({
            X(0): Pose.from_matrix(wTbs[i]), V(0): state.vs[i],
            X(1): Pose.from_matrix(wTbs[i + 1]), V(1): state.vs[i + 1],
            B(0): state.bs[i], B(1): state.bs[i + 1],
        })
        r, J = f.error_and_jacobians(vals)
        tmp_A = J[B(0)][0:3, 3:6]
        tmp_b = r[0:3]
        A += tmp_A.T @ tmp_A
        b += tmp_A.T @ tmp_b
    bg = -np.linalg.solve(A, b)

    new_bias = np.concatenate([np.zeros(3), bg])
    for i in range(0, t1 - 1):
        state.preintegrations[i].reintegrate(state.params, new_bias)
        state.bs[i] = new_bias.copy()

    # --- linearAlignment (dbaf_frontend.py:653-696)
    n_frames = t1 - t0
    n_state = n_frames * 3 + 3 + 1
    A = np.zeros((n_state, n_state))
    b = np.zeros(n_state)
    ic = 0
    for i in range(t0, t1 - 1):
        R_i = wTbs[i, 0:3, 0:3]
        t_i = wTbs[i, 0:3, 3]
        R_j = wTbs[i + 1, 0:3, 0:3]
        t_j = wTbs[i + 1, 0:3, 3]
        pim = state.preintegrations[i]
        dt = pim.dt

        tA = np.zeros((6, 10))
        tb = np.zeros(6)
        tA[0:3, 0:3] = -dt * np.eye(3)
        tA[0:3, 6:9] = R_i.T * dt * dt / 2
        tA[0:3, 9] = R_i.T @ (t_j - t_i) / 100.0
        tb[0:3] = pim.dp
        tA[3:6, 0:3] = -np.eye(3)
        tA[3:6, 3:6] = R_i.T @ R_j
        tA[3:6, 6:9] = R_i.T * dt
        tb[3:6] = pim.dv

        rA = tA.T @ tA
        rb = tA.T @ tb
        A[ic * 3 : ic * 3 + 6, ic * 3 : ic * 3 + 6] += rA[0:6, 0:6]
        b[ic * 3 : ic * 3 + 6] += rb[0:6]
        A[-4:, -4:] += rA[-4:, -4:]
        b[-4:] += rb[-4:]
        A[ic * 3 : ic * 3 + 6, n_state - 4 :] += rA[0:6, -4:]
        A[n_state - 4 :, ic * 3 : ic * 3 + 6] += rA[-4:, 0:6]
        ic += 1

    x = np.linalg.solve(A * 1000.0, b * 1000.0)
    s = x[-1] / 100.0
    g = x[-4:-1]

    # --- RefineGravity (dbaf_frontend.py:700-762)
    g0 = g / np.linalg.norm(g) * 9.81
    n_state = n_frames * 3 + 2 + 1
    for _ in range(4):
        aa = g0 / np.linalg.norm(g0)
        tmp = np.array([0.0, 0.0, 1.0])
        bb = tmp - (aa @ tmp) * aa
        bb /= np.linalg.norm(bb)
        cc = np.cross(aa, bb)
        lxly = np.stack([bb, cc], axis=1)

        A = np.zeros((n_state, n_state))
        b = np.zeros(n_state)
        ic = 0
        for i in range(t0, t1 - 1):
            R_i = wTbs[i, 0:3, 0:3]
            t_i = wTbs[i, 0:3, 3]
            R_j = wTbs[i + 1, 0:3, 0:3]
            t_j = wTbs[i + 1, 0:3, 3]
            pim = state.preintegrations[i]
            dt = pim.dt

            tA = np.zeros((6, 9))
            tb = np.zeros(6)
            tA[0:3, 0:3] = -dt * np.eye(3)
            tA[0:3, 6:8] = R_i.T @ lxly * dt * dt / 2
            tA[0:3, 8] = R_i.T @ (t_j - t_i) / 100.0
            tb[0:3] = pim.dp - R_i.T @ g0 * dt * dt / 2
            tA[3:6, 0:3] = -np.eye(3)
            tA[3:6, 3:6] = R_i.T @ R_j
            tA[3:6, 6:8] = R_i.T @ lxly * dt
            tb[3:6] = pim.dv - R_i.T @ g0 * dt

            rA = tA.T @ tA
            rb = tA.T @ tb
            A[ic * 3 : ic * 3 + 6, ic * 3 : ic * 3 + 6] += rA[0:6, 0:6]
            b[ic * 3 : ic * 3 + 6] += rb[0:6]
            A[-3:, -3:] += rA[-3:, -3:]
            b[-3:] += rb[-3:]
            A[ic * 3 : ic * 3 + 6, n_state - 3 :] += rA[0:6, -3:]
            A[n_state - 3 :, ic * 3 : ic * 3 + 6] += rA[-3:, 0:6]
            ic += 1

        x = np.linalg.solve(A * 1000.0, b * 1000.0)
        dg = x[-3:-1]
        g0 = g0 + lxly @ dg
        g0 = g0 / np.linalg.norm(g0) * 9.81
        s = x[-1] / 100.0

    if disable_scale:
        s = 1.0

    # --- visualInitialAlign + g2R (dbaf_frontend.py:771-814)
    wTbs[:, 0:3, 3] *= s
    for i in range(0, t1 - t0):
        state.vs[i + t0] = wTbs[i + t0, 0:3, 0:3] @ x[i * 3 : i * 3 + 3]

    ng1 = g0 / np.linalg.norm(g0)
    R0 = geodesy.from_two_vectors(ng1, np.array([0.0, 0.0, 1.0]))
    yaw = geodesy.matrix_to_ypr(R0)[0]
    R0 = geodesy.ypr_to_matrix(np.array([-yaw, 0.0, 0.0])) @ R0

    for i in range(0, t1):
        wTbs[i, 0:3, 3] = R0 @ wTbs[i, 0:3, 3]
        wTbs[i, 0:3, 0:3] = R0 @ wTbs[i, 0:3, 0:3]
        state.vs[i] = R0 @ state.vs[i]
        state.wTbs[i] = Pose.from_matrix(wTbs[i])

    coupled.vi_init_t1 = t1
    coupled.vi_init_time = float(video.tstamp[t1 - 1])

    write_camera_poses(video, wTbs, coupled.Tbc, t1, scale=s,
                       ignore_lever=ignore_lever)
    return s, R0 @ g0


def init_gnss(video: DepthVideo, coupled: MultiSensorBA, t1: int,
              ten0: np.ndarray) -> bool:
    """Heading/scale alignment of the world frame to local ENU once the
    GNSS baseline exceeds 10 m (dbaf_frontend.py:517-604)."""
    state = coupled.state
    coupled.ten0 = np.asarray(ten0, float)
    tn0, tw = [], []
    for i in range(max(len(state.wTbs) - 10, 0), len(state.wTbs)):
        if state.gnss_valid[i]:
            tn0.append(
                geodesy.Cen(coupled.ten0).T @ (state.gnss_position[i] - coupled.ten0)
            )
            tw.append(state.wTbs[i].t)
    if len(tn0) < 2:
        return False
    tn0 = np.asarray(tn0)
    tw = np.asarray(tw)
    bl = np.linalg.norm(tn0[-1] - tn0[0])
    if bl < 10.0:
        return False

    heading_w = np.arctan2(tw[-1, 1] - tw[0, 1], tw[-1, 0] - tw[0, 0])
    heading_n0 = np.arctan2(tn0[-1, 1] - tn0[0, 1], tn0[-1, 0] - tn0[0, 0])
    s = np.linalg.norm(tn0[-1] - tn0[0]) / max(np.linalg.norm(tw[-1] - tw[0]), 1e-9)
    Rn0w = geodesy.ypr_to_matrix(
        np.array([np.rad2deg(heading_n0 - heading_w), 0.0, 0.0])
    )
    tn0w = tn0 - (Rn0w @ (tw.T * s)).T

    wTbs = body_poses_from_video(video, coupled.Tbc, t1, ignore_lever=False)
    wTbs[:, 0:3, 3] = (Rn0w @ (wTbs[:, 0:3, 3] * s).T).T + tn0w[0]
    wTbs[:, 0:3, 0:3] = np.einsum("ab,nbc->nac", Rn0w, wTbs[:, 0:3, 0:3])

    for i in range(0, t1):
        state.wTbs[i] = Pose.from_matrix(wTbs[i])
        state.vs[i] = state.vs[i] * s
    write_camera_poses(video, wTbs, coupled.Tbc, t1, scale=s)

    # the rewrite moved every state into the georeferenced frame: the
    # device-solver caches hold old-world values and must rebuild from the
    # rewritten mirrors, and the marginal prior goes too -- its
    # linearization anchors the old world, and after a yaw rewrite its
    # attitude information pulls the window back by that yaw, leaking
    # gravity into the estimate.  The reference keeps it through init_GNSS
    # (dbaf_frontend.py:517-604); set_prior below re-anchors pose and bias
    # on the first two window states instead.
    coupled.invalidate_device_state()

    coupled.gnss_init_t1 = t1
    coupled.gnss_init_time = float(video.tstamp[t1 - 1])
    coupled.set_prior(coupled.last_t0, t1)
    return True
