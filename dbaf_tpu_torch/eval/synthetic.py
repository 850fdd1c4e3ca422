"""Synthetic-scene simulator: the dataset-free end-to-end backend (port of
``dbaf_tpu/eval/synthetic.py``).

A multi-view-consistent world (a plane seen from a smooth trajectory), an
oracle update operator (a 'perfect network' that returns the true
correspondences, in torch) and a simulated IMU exercise the whole SLAM
machinery without datasets or checkpoints.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..fusion.se3np import so3_exp
from ..ops import lie_np
from ..ops import projective as pj

GRAVITY_W = np.array([0.0, 0.0, -9.807])


def plane_disparity(pose_wc: np.ndarray, intr: np.ndarray, h8: int, w8: int,
                    z0: float = 3.0) -> np.ndarray:
    """Ground-truth disparity of the world plane z=z0 for a world->cam
    7-vec pose."""
    fx, fy, cx, cy = intr
    R = lie_np.quat_to_matrix(np.asarray(pose_wc[3:], np.float64))
    t = pose_wc[:3]
    u, v = np.meshgrid(np.arange(w8), np.arange(h8), indexing="xy")
    dirs = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u, dtype=float)], -1)
    dir_w = dirs @ R  # R^T dir
    tz = (R.T @ t)[2]
    z = (z0 + tz) / dir_w[..., 2]
    return (1.0 / z).astype(np.float32)


def body_state(t: float):
    """Analytic trajectory with strong high-frequency excitation at moderate
    velocity, so the VI alignment's scale/gravity signal (0.5*|a|*dt^2 per
    keyframe interval) clears the visual noise floor at init time."""
    p = np.array([0.15 * np.sin(10.0 * t), 0.13 * np.cos(9.0 * t), 0.25 * t])
    v = np.array([1.5 * np.cos(10.0 * t), -1.17 * np.sin(9.0 * t), 0.25])
    a = np.array([-15.0 * np.sin(10.0 * t), -10.53 * np.cos(9.0 * t), 0.0])
    w = np.array([0.25 * np.sin(0.9 * t), 0.2 * np.cos(0.7 * t), 0.15])
    return p, v, a, w


def simulate_imu_and_poses(duration: float, fps: float = 10.0, imu_hz: float = 200.0):
    """Returns IMU rows [t, gyro_deg(3), acc(3)] and {frame_id: (R, p)}."""
    dt = 1.0 / imu_hz
    ts = np.arange(0.0, duration + dt / 2, dt)
    R = np.eye(3)
    rows = []
    poses_at: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for t in ts:
        p, v, a, w = body_state(t)
        fid = t * fps
        if abs(fid - round(fid)) < 1e-6:
            poses_at[int(round(fid))] = (R.copy(), p)
        acc_body = R.T @ (a - GRAVITY_W)
        rows.append(np.concatenate([[t], np.rad2deg(w), acc_body]))
        R = R @ so3_exp(w * dt)
    return np.asarray(rows), poses_at


def scene_from_poses(poses_at, n_frames: int, intr: np.ndarray, h8: int, w8: int,
                     z0: float = 4.0):
    """Ground-truth camera Tcw 7-vecs + plane disparities per frame."""
    gt_cw, gt_disps = [], []
    for k in range(n_frames + 1):
        R, p = poses_at[k]
        Twc = np.eye(4)
        Twc[:3, :3] = R
        Twc[:3, 3] = p
        pose7 = lie_np.se3_from_matrix(np.linalg.inv(Twc))
        gt_cw.append(pose7)
        gt_disps.append(plane_disparity(pose7, intr, h8, w8, z0))
    return np.stack(gt_cw).astype(np.float32), np.stack(gt_disps).astype(np.float32)


def make_oracle(gt_poses_cw, gt_disps, intr, noise_px: float = 0.0, device=None):
    """'Perfect network' update operator: true correspondences, weight 1.

    Frame identity travels in ``aux['id_map']`` (video slot -> ground-truth
    frame id, a device int64 tensor) so culls and rollups stay correct.

    ``noise_px`` adds zero-mean per-pixel pseudo-noise (std about
    ``noise_px``) to the targets, drawn by the JAX package's hash of the
    current reprojection and the edge (dbaf_tpu/eval/synthetic.py:98-135),
    so every round sees fresh draws; 0.0 keeps the exact oracle."""
    gtp = torch.as_tensor(np.asarray(gt_poses_cw, np.float32), device=device)
    gtd = torch.as_tensor(np.asarray(gt_disps, np.float32), device=device)
    intr8 = torch.as_tensor(np.asarray(intr, np.float32), device=device)
    k1 = torch.tensor([12.9898, 78.233], device=device)
    k2 = torch.tensor([39.3467, 11.135], device=device)

    def update_fn(net, inp, corr, motn, ii, jj, aux):
        id_map = aux["id_map"]
        target, valid = pj.projective_transform(gtp, gtd, intr8, id_map[ii], id_map[jj])
        c1 = aux["coords1"]
        if noise_px:
            phase = (c1 * k1 + c1.flip(-1) * k2
                     + ii[:, None, None, None].float() * 0.7311
                     + jj[:, None, None, None].float() * 1.2371)
            h = torch.sin(phase.sum(-1, keepdim=True) * 43758.5453)
            h2 = torch.cat([h, torch.sin(h * 24634.6345 + 1.0)], dim=-1)
            # the sine of a fast phase: about zero-mean, std 1/sqrt(2), bounded
            target = target + (noise_px * 1.414) * torch.sin(h2 * 971.487)
        delta = target - c1
        return net, delta.float(), valid.expand(delta.shape).float()

    return update_fn
