"""SubT handheld demo: a long sequence in degraded lighting (port of
``dbaf_tpu/apps/demo_subt.py``, the reference's demo_vio_subt.py).

Usage:
    python -m dbaf_tpu_torch.apps.demo_subt --imagedir .../cam_0 \\
        --calib calib/subt.txt --weights droid.pth --imupath .../imu_data.csv \\
        [--Tbc Tbc.txt]

The images need OpenCV; the system runs on the card.  ``setup`` does
everything ``main`` does before the first frame.
"""

from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--imagedir", required=True)
    ap.add_argument("--calib", required=True)
    ap.add_argument("--weights", required=True)
    ap.add_argument("--selftest", action="store_true",
                    help="validate the checkpoint conversion and exit")
    ap.add_argument("--imupath", required=True)
    ap.add_argument("--Tbc", default=None,
                    help="path to a 4x4 body<-camera extrinsic (txt)")
    ap.add_argument("--stride", type=int, default=8)
    ap.add_argument("--resultpath", default="result_subt.txt")
    ap.add_argument("--gtpath", default=None)
    ap.add_argument("--save_pkl", action="store_true")
    ap.add_argument("--pklpath", default="reconstruction_subt.pkl")
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--monitor", default="", metavar="DIR",
                    help="dump the live-monitor panels and debug views"
                         " as PNGs into DIR (dbaf_frontend.py:76-83)")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace, device=None):
    """The system with the SubT preset and its IMU, and the CLAHE frame
    stream (not yet read).  ``device`` defaults to the card."""
    from ..data.streams import image_stream, load_imu
    from ..slam.system import DBAFusion
    from ..utils.config import subt_config

    cfg = subt_config(weights_path=args.weights, save_pkl=args.save_pkl)
    cfg.frontend.monitor_dir = args.monitor
    system = DBAFusion(cfg, device=device)

    all_imu = load_imu(args.imupath, gyro_unit="rad")
    Tbc = np.loadtxt(args.Tbc).reshape(4, 4) if args.Tbc else np.eye(4)
    system.set_multisensor(all_imu, Tbc=Tbc)

    return system, image_stream(args.imagedir, args.calib, args.stride, clahe=True)


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
