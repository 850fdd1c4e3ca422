"""KITTI-360 visual-inertial demo (port of ``dbaf_tpu/apps/demo_kitti360.py``,
the reference's demo_vio_kitti360.py).

Usage:
    python -m dbaf_tpu_torch.apps.demo_kitti360 --imagedir .../image_00/data_rgb \\
        --calib calib/kitti_360.txt --weights droid.pth --imupath .../imu.txt

The images need OpenCV; the system runs on the card.  ``setup`` does
everything ``main`` does before the first frame.
"""

from __future__ import annotations

import argparse
import itertools
import os

import numpy as np

# Ti1c == Tbc (demo_vio_kitti360.py:176-181)
KITTI360_TBC = np.array(
    [
        [0.99944133, -0.00228419, -0.03334389, -0.03734697],
        [0.03268308, -0.14183394, 0.98935078, 1.75837780],
        [-0.00698916, -0.98988784, -0.14168005, 0.59911765],
        [0.0, 0.0, 0.0, 1.0],
    ]
)
KITTI360_IMU_NOISE = [0.0003924 * 25, 0.000205689024915 * 25, 0.004905 * 10,
                      0.000001454441043 * 500]
IMU_CAM_TIME_OFFSET = -0.04  # demo_vio_kitti360.py:164


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--imagedir", required=True)
    ap.add_argument("--calib", required=True)
    ap.add_argument("--weights", required=True)
    ap.add_argument("--selftest", action="store_true",
                    help="validate the checkpoint conversion and exit")
    ap.add_argument("--imupath", required=True)
    ap.add_argument("--stride", type=int, default=2)
    ap.add_argument("--resultpath", default="result_kitti360.txt")
    ap.add_argument("--gtpath", default=None)
    ap.add_argument("--save_pkl", action="store_true")
    ap.add_argument("--pklpath", default="reconstruction_kitti360.pkl")
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--monitor", default="", metavar="DIR",
                    help="dump the live-monitor panels and debug views"
                         " as PNGs into DIR (dbaf_frontend.py:76-83)")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace, device=None):
    """The system with the KITTI-360 preset and its IMU (whitespace rows
    in seconds and deg/s, moved by the camera's time offset), and the frame
    stream.  The system is built at the size of the stream's first frame
    (read here, and yielded again first), as DROID-SLAM's demos size their
    video; where the image folder is empty, at the preset's, which is what
    the stream makes of a 376 x 1408 image.  ``device`` defaults to the
    card."""
    from ..data.streams import kitti360_stream
    from ..slam.system import DBAFusion
    from ..utils.config import kitti360_config

    stream = kitti360_stream(args.imagedir, args.calib, args.stride)
    first = next(stream, None) if os.listdir(args.imagedir) else None
    if first is not None:
        stream = itertools.chain([first], stream)
    cfg = kitti360_config(weights_path=args.weights, save_pkl=args.save_pkl)
    if first is not None:
        cfg.image_size = tuple(first[1].shape[:2])
    cfg.frontend.monitor_dir = args.monitor
    system = DBAFusion(cfg, device=device)

    all_imu = np.loadtxt(args.imupath)
    all_imu[:, 0] += IMU_CAM_TIME_OFFSET
    system.set_multisensor(all_imu, Tbc=KITTI360_TBC, imu_noise=KITTI360_IMU_NOISE)
    c = system.graph.coupled
    c.init_pose_sigma = np.array([1.0, 1.0, 0.0001, 1.0, 1.0, 1.0])
    c.init_bias_sigma = np.array([0.1] * 6)

    return system, stream


def main(argv=None):
    from . import runner

    args = parse_args(argv)
    if args.selftest:
        runner.weights_selftest(args.weights)
        return
    system, stream = setup(args)
    runner.run(system, stream, args.resultpath, args.pklpath, args.gtpath, args.max_frames)


if __name__ == "__main__":
    main()
