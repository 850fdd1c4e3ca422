"""The benchmark's one traffic generator: a synthetic world, its sensors and
its frames, from a traffic mix's parameters, a configuration and a seed.

A traffic file (``perfbench/traffic/<mix>.json``) gives the body's motion
as sums of sinusoids and drifts, the camera's focal length and the plane it
looks at, the frame and IMU rates, and which frames carry a GNSS fix and a
wheel-odometry reading.  The configuration gives the sensors' extrinsics.

Frozen copies, each from the port at commit fc1ed8f:

* :func:`simulate_imu` -- ``dbaf_tpu_torch/eval/synthetic.py:57-74``
  (``simulate_imu_and_poses``), with the body state a parameter;
* :func:`plane_disparity` and :func:`scene_from_poses` --
  ``dbaf_tpu_torch/eval/synthetic.py:24-38,77-90``;
* the extrinsic turn of the body and the camera's lever arm --
  ``chip_smoke.py:2331-2370`` (``DemoScene``);
* :func:`ecef_of` -- ``chip_smoke.py:2314-2320`` (``whu_ecef``) with the
  port's ``utils/geodesy.py:Cen``;
* the oracle -- ``dbaf_tpu_torch/eval/synthetic.py:93-127`` (``make_oracle``,
  without noise), its reprojection the plain one of
  ``perfbench/reference/geometry.py``.

The seed draws the texture; the motion and the sensors' cadence are the
mix's own, so every seed asks for the same work.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

GRAVITY_W = np.array([0.0, 0.0, -9.807])


# ---------------------------------------------------------------------------
# motion
# ---------------------------------------------------------------------------

class Motion:
    """Body position ``p_i(t) = A_i sin(w_i t + phi_i) + V_i t`` and body
    rate ``w_i(t) = B_i sin(nu_i t + psi_i) + C_i``, world frame, per axis."""

    def __init__(self, spec: dict):
        self.A = np.asarray(spec["pos_amp"], float)
        self.w = np.asarray(spec["pos_freq"], float)
        self.phi = np.asarray(spec["pos_phase"], float)
        self.V = np.asarray(spec["pos_drift"], float)
        self.B = np.asarray(spec["rate_amp"], float)
        self.nu = np.asarray(spec["rate_freq"], float)
        self.psi = np.asarray(spec["rate_phase"], float)
        self.C = np.asarray(spec["rate_bias"], float)

    def __call__(self, t: float):
        """(p, v, a, w) at time t."""
        s = np.sin(self.w * t + self.phi)
        c = np.cos(self.w * t + self.phi)
        p = self.A * s + self.V * t
        v = self.A * self.w * c + self.V
        a = -self.A * self.w ** 2 * s
        rate = self.B * np.sin(self.nu * t + self.psi) + self.C
        return p, v, a, rate


def so3_exp(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    K = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-10:
        return np.eye(3) + K
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th ** 2 * K @ K


def simulate_imu(state_fn, duration: float, fps: float, imu_hz: float):
    """IMU rows [t, gyro deg/s (3), specific force (3)] of the simulated
    frame S, and {frame: (R_wS, p)} at every frame stamp."""
    dt = 1.0 / imu_hz
    ts = np.arange(0.0, duration + dt / 2, dt)
    R = np.eye(3)
    rows = []
    poses_at: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for t in ts:
        p, v, a, w = state_fn(t)
        fid = t * fps
        if abs(fid - round(fid)) < 1e-6:
            poses_at[int(round(fid))] = (R.copy(), p)
        rows.append(np.concatenate([[t], np.rad2deg(w), R.T @ (a - GRAVITY_W)]))
        R = R @ so3_exp(w * dt)
    return np.asarray(rows), poses_at


# ---------------------------------------------------------------------------
# camera geometry
# ---------------------------------------------------------------------------

def _quat_from_matrix(R: np.ndarray) -> np.ndarray:
    """[qx, qy, qz, qw] of a rotation matrix."""
    tr = np.trace(R)
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        q = [(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s, 0.25 * s]
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k])
        q = [0.0] * 4
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        q[3] = (R[k, j] - R[j, k]) / s
    q = np.asarray(q)
    return q * np.sign(q[3]) if q[3] != 0 else q


def pose7_cw(R_wc: np.ndarray, p_wc: np.ndarray) -> np.ndarray:
    """World-to-camera [t, q] 7-vector of a camera-to-world pose."""
    R = R_wc.T
    return np.concatenate([-R @ p_wc, _quat_from_matrix(R)])


def plane_disparity(R_cw: np.ndarray, t_cw: np.ndarray, intr: np.ndarray, h8: int, w8: int,
                    z0: float) -> np.ndarray:
    """Disparity of the world plane z = z0 seen by a world->camera pose."""
    fx, fy, cx, cy = intr
    u, v = np.meshgrid(np.arange(w8), np.arange(h8), indexing="xy")
    dirs = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u, dtype=float)], -1)
    dir_w = dirs @ R_cw
    tz = (R_cw.T @ t_cw)[2]
    return (dir_w[..., 2] / (z0 + tz)).astype(np.float32)


def scene_from_poses(cam: dict, n_frames: int, intr: np.ndarray, h8: int, w8: int, z0: float):
    """Ground-truth camera 7-vectors (world->camera) and plane disparities."""
    gt_cw, gt_disps = [], []
    for k in range(n_frames + 1):
        R, p = cam[k]
        pose = pose7_cw(R, p)
        gt_cw.append(pose)
        gt_disps.append(plane_disparity(R.T, pose[:3], intr, h8, w8, z0))
    return np.stack(gt_cw).astype(np.float32), np.stack(gt_disps).astype(np.float32)


# ---------------------------------------------------------------------------
# GNSS
# ---------------------------------------------------------------------------

def Cen(ecef: np.ndarray) -> np.ndarray:
    """ENU -> ECEF rotation at an ECEF point (WGS-84 geodetic latitude)."""
    a, f = 6378137.0, 1.0 / 298.257223563
    e2 = f * (2 - f)
    x, y, z = ecef
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1 - e2))
    for _ in range(8):
        N = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
        h = p / np.cos(lat) - N
        lat = np.arctan2(z, p * (1 - e2 * N / (N + h)))
    sl, cl, so, co = np.sin(lat), np.cos(lat), np.sin(lon), np.cos(lon)
    return np.array([[-so, -sl * co, cl * co], [co, -sl * so, cl * so], [0.0, cl, sl]])


def ecef_of(p_world: np.ndarray, gnss: dict) -> np.ndarray:
    """ECEF of a world position through the mix's yawed, offset ENU frame."""
    psi = np.deg2rad(gnss["enu_yaw_deg"])
    Rz = np.array([[np.cos(psi), -np.sin(psi), 0.0], [np.sin(psi), np.cos(psi), 0.0],
                   [0.0, 0.0, 1.0]])
    base = np.asarray(gnss["ecef_base"], float)
    return base + Cen(base) @ (Rz @ np.asarray(p_world, float) + np.asarray(gnss["enu_offset"]))


# ---------------------------------------------------------------------------
# the scene
# ---------------------------------------------------------------------------

class Scene:
    """Everything a run feeds the system: frames, intrinsics, IMU rows,
    GNSS and odometry rows, the extrinsics, and the oracle's ground truth."""

    def __init__(self, traffic: dict, config: dict, seed: int):
        self.fps = float(traffic["fps"])
        self.n_frames = int(traffic["frames"])
        state_fn = Motion(traffic["motion"])
        rows, poses_s = simulate_imu(state_fn, self.n_frames / self.fps + 0.5, self.fps,
                                     float(traffic["imu_hz"]))
        sensors = config["sensors_of_deployment"]
        self.Tbc = np.asarray(sensors["Tbc"], float)
        Rbc, tbc = self.Tbc[:3, :3], self.Tbc[:3, 3]
        # the body is S turned by the extrinsic, at S's position
        self.imu = rows.copy()
        self.imu[:, 1:4] = rows[:, 1:4] @ Rbc.T
        self.imu[:, 4:7] = rows[:, 4:7] @ Rbc.T
        self.body = {k: (R @ Rbc.T, p) for k, (R, p) in poses_s.items()}
        cam = {k: (R, p + R @ (Rbc.T @ tbc)) for k, (R, p) in poses_s.items()}
        HT, WD = config["dbafusion"]["image_size"]
        self.image_size = (HT, WD)
        H8, W8 = HT // 8, WD // 8
        f8 = float(traffic["focal"]) * W8
        self.intr8 = np.asarray([f8, f8, W8 / 2, H8 / 2], np.float32)
        z_plane = float(traffic["plane_z"]) + (Rbc.T @ tbc)[2]
        self.gt_cw, self.gt_disps = scene_from_poses(cam, self.n_frames, self.intr8, H8, W8,
                                                     z_plane)
        self.tbg = None if sensors.get("tbg") is None else np.asarray(sensors["tbg"], float)
        self.gnss = self.odo = self.ten0 = None
        n = self.n_frames
        g = self.gnss_spec = traffic.get("gnss")
        if g:
            lever = np.zeros(3) if self.tbg is None else self.tbg
            fixes = [[k / self.fps, *ecef_of(self.body[k][1] + self.body[k][0] @ lever, g)]
                     for k in range(0, n, int(g["every"]))]
            self.gnss = np.asarray(fixes)
            self.ten0 = self.gnss[0, 1:4].copy()
        o = traffic.get("odometry")
        if o:
            self.odo = np.asarray([[k / self.fps, *(self.body[k][0].T @ state_fn(k / self.fps)[1])]
                                   for k in range(0, n, int(o["every"]))])
        rng = np.random.default_rng(seed)
        self.texture = rng.integers(0, 255, size=(HT + 64, WD + 64, 3)).astype(np.uint8)

    def frame(self, k: int) -> np.ndarray:
        """Frame k: a crop of the seeded texture that moves with k."""
        if k >= self.n_frames:
            raise RuntimeError(f"the scene has {self.n_frames} frames and frame {k} was asked "
                               "for: the traffic's 'frames' is too short for the window")
        HT, WD = self.image_size
        ox, oy = (3 * k) % 64, (2 * k) % 64
        return self.texture[oy:oy + HT, ox:ox + WD]

    def truth(self, frames):
        """The body's true rotations (N, 3, 3) and positions (N, 3) at
        ``frames``, and its ECEF positions where the mix has GNSS."""
        R = np.asarray([self.body[k][0] for k in frames]).reshape(-1, 3, 3)
        p = np.asarray([self.body[k][1] for k in frames]).reshape(-1, 3)
        ecef = None
        if self.gnss_spec:
            ecef = np.asarray([ecef_of(x, self.gnss_spec) for x in p]).reshape(-1, 3)
        return R, p, ecef

    def sensors(self) -> dict:
        """``DBAFusion.set_multisensor``'s sensor keywords."""
        return dict(all_gnss=self.gnss, all_odo=self.odo, ten0=self.ten0, tbg=self.tbg)


def make_oracle(gt_poses_cw, gt_disps, intr, device):
    """The 'perfect network': true correspondences and weight 1 for every
    edge, the frame of each video slot read from ``aux['id_map']``."""
    import torch

    from .reference.geometry import reproject

    gtp = torch.as_tensor(np.asarray(gt_poses_cw, np.float32), device=device)
    gtd = torch.as_tensor(np.asarray(gt_disps, np.float32), device=device)
    intr8 = torch.as_tensor(np.asarray(intr, np.float32), device=device)

    def update_fn(net, inp, corr, motn, ii, jj, aux):
        id_map = aux["id_map"]
        target, valid = reproject(gtp, gtd, intr8, id_map[ii], id_map[jj])
        delta = target - aux["coords1"]
        return net, delta.float(), valid.expand(delta.shape).float()

    return update_fn
