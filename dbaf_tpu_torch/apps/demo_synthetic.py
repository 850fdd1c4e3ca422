"""Dataset-free end-to-end demo on the synthetic scene (port of
``dbaf_tpu/apps/demo_synthetic.py``).

Runs the streaming system -- keyframe store, covisibility graph, update
rounds, dense BA, and with ``--multisensor`` the IMU factor graph --
against a planar world with an oracle update operator, and prints the
trajectory's accuracy as one JSON line.

Usage:
    python -m dbaf_tpu_torch.apps.demo_synthetic [--frames 26] [--multisensor]
        [--device-solver] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=26)
    ap.add_argument("--multisensor", action="store_true")
    ap.add_argument("--h8", type=int, default=8)
    ap.add_argument("--w8", type=int, default=16)
    ap.add_argument("--traj_out", type=str, default="")
    ap.add_argument("--lm-iters", type=int, default=2,
                    help="coupled visual-relinearize/LM passes per round (reference: 2)")
    ap.add_argument("--device-solver", action="store_true",
                    help="the coupled solve on the device (the port's device factor graph)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    args = ap.parse_args(argv)

    from ..eval.ate import ate_rmse
    from ..eval.synthetic import make_oracle, scene_from_poses, simulate_imu_and_poses
    from ..eval.traj_io import write_tum
    from ..fusion.se3np import Pose
    from ..ops import lie_np
    from ..slam.coupled import MultiSensorBA
    from ..slam.frontend import Frontend
    from ..slam.graph import CovisibleGraph
    from ..slam.video import DepthVideo
    from ..utils.config import BAConfig, DBAFusionConfig, FrontendConfig, GraphConfig
    from ..utils.device import resolve_device, to_host, upload

    dev = resolve_device(args.device)
    h8, w8 = args.h8, args.w8
    fps = 10.0
    n = args.frames
    intr = np.asarray([2.0 * w8, 2.0 * w8, w8 / 2, h8 / 2], dtype=np.float32)
    imu_rows, poses_at = simulate_imu_and_poses(n / fps + 0.5, fps=fps)
    gt_cw, gt_disps = scene_from_poses(poses_at, n, intr, h8, w8)

    cfg = DBAFusionConfig(
        image_size=(8 * h8, 8 * w8),
        buffer=max(48, n + 8),
        graph=GraphConfig(max_factors=40, edge_capacity=72, inactive_capacity=72,
                          frontend_thresh=20.0),
        frontend=FrontendConfig(warmup=8, vi_warmup=12, keyframe_thresh=-1.0, iters1=2,
                                iters2=1, init_iters=4, rollup_start=1000),
        ba=BAConfig(window=max(32, n + 4), lm_iters=args.lm_iters),
    )
    if args.device_solver:
        cfg.sensors.device_solver = True

    video = DepthVideo(cfg, dev)
    graph = CovisibleGraph(video, make_oracle(gt_cw, gt_disps, intr, device=dev), cfg)
    frontend = Frontend(video, graph, cfg)
    if args.multisensor:
        coupled = MultiSensorBA(video, cfg)
        coupled.Tbc = Pose()
        coupled.state.set_imu_params([0.05, 0.005, 1e-4, 1e-6])
        graph.coupled = coupled
        frontend.set_multisensor(imu_rows, visual_only=False)

    zeros_feat = torch.zeros((h8, w8, 128), dtype=torch.bfloat16, device=dev)
    id_map = np.zeros(cfg.buffer, dtype=np.int64)
    intr8 = torch.as_tensor(intr, device=dev)
    for k in range(n):
        idx = video.counter
        video.append(k / fps, None, None, None, intr8, zeros_feat, zeros_feat, zeros_feat)
        id_map[idx] = k
        graph.aux = {"id_map": upload(id_map, dev)}
        frontend()
        id_map[:video.counter] = np.round(video.tstamp[:video.counter] * fps).astype(np.int64)
        graph.aux = {"id_map": upload(id_map, dev)}

    t1 = frontend.t1
    gt_ids = np.round(video.tstamp[:t1] * fps).astype(int)
    ref = np.stack([poses_at[g][1] for g in gt_ids])
    if args.multisensor and video.imu_enabled:
        est = np.asarray([graph.coupled.state.wTbs[k].t for k in range(t1)])
        align = "se3"  # metric scale must be recovered
    else:
        est = lie_np.se3_inv(to_host(video.poses[:t1]).astype(np.float64))[:, :3]
        align = "sim3"  # monocular gauge
    rmse = ate_rmse(est, ref, align=align)
    span = float(np.linalg.norm(ref.max(0) - ref.min(0)))

    if args.traj_out:
        write_tum(args.traj_out, [np.concatenate([[video.tstamp[k]], est[k], [0, 0, 0, 1]])
                                  for k in range(t1)])

    result = {
        "mode": "multisensor" if args.multisensor else "visual",
        "keyframes": int(t1),
        "imu_enabled": bool(video.imu_enabled),
        "ate_rmse": round(rmse, 4),
        "traj_span": round(span, 3),
        "ate_pct_of_span": round(100 * rmse / max(span, 1e-9), 2),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
