"""WHU multi-sensor demo: VIO with wheel odometry, GNSS and ZUPT (port of
``dbaf_tpu/apps/demo_whu.py``, the reference's demo_vio_whu.py).

Usage:
    python -m dbaf_tpu_torch.apps.demo_whu --imagedir ... --imagestamp ... \\
        --calib calib/whu.txt --weights droid.pth --imupath ... \\
        [--use_gnss --gnsspath ...] [--use_odo --odopath ...] [--use_zupt]

The images need OpenCV; the system runs on the card.  ``setup`` does
everything ``main`` does before the first frame.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

WHU_TBC = np.array(
    [
        [0.99988370, -0.00563944, -0.01418468, -0.15590000],
        [0.01424932, 0.01159187, 0.99983149, 0.63466000],
        [-0.00547407, -0.99991712, 0.01167088, 0.04605000],
        [0.0, 0.0, 0.0, 1.0],
    ]
)
WHU_TBG = np.array([-0.0125, -0.26, 0.2091])  # GNSS lever arm
WHU_IMU_NOISE = [0.0003924 * 25, 0.000205689024915 * 25, 0.004905 * 10,
                 0.000001454441043 * 25]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--imagedir", required=True)
    ap.add_argument("--imagestamp", required=True)
    ap.add_argument("--calib", required=True)
    ap.add_argument("--weights", required=True)
    ap.add_argument("--selftest", action="store_true",
                    help="validate the checkpoint conversion and exit")
    ap.add_argument("--imupath", required=True)
    ap.add_argument("--stride", type=int, default=2)
    ap.add_argument("--use_gnss", action="store_true")
    ap.add_argument("--gnsspath", default=None)
    ap.add_argument("--use_odo", action="store_true")
    ap.add_argument("--odopath", default=None)
    ap.add_argument("--use_zupt", action="store_true")
    ap.add_argument("--resultpath", default="result_whu.txt")
    ap.add_argument("--gtpath", default=None)
    ap.add_argument("--save_pkl", action="store_true")
    ap.add_argument("--pklpath", default="reconstruction_whu.pkl")
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--monitor", default="", metavar="DIR",
                    help="dump the live-monitor panels and debug views"
                         " as PNGs into DIR (dbaf_frontend.py:76-83)")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace, device=None):
    """The system with the WHU preset, its IMU, GNSS and odometry, and the
    frame stream (not yet read).  ``device`` defaults to the card."""
    from ..data.streams import image_stream, load_imu, load_stamps
    from ..slam.system import DBAFusion
    from ..utils.config import whu_config

    cfg = whu_config(weights_path=args.weights, save_pkl=args.save_pkl)
    cfg.frontend.monitor_dir = args.monitor
    cfg.sensors.use_zupt = args.use_zupt
    system = DBAFusion(cfg, device=device)

    all_imu = load_imu(args.imupath, time_scale=1.0, gyro_unit="deg")

    all_gnss = None
    ten0 = None
    if args.use_gnss and args.gnsspath and os.path.isfile(args.gnsspath):
        # GNSS rows with a Fixed/Float quality column (demo_vio_whu.py:177-180)
        fix_map = {b"Fixed": 1.0, b"Float": 0.0}
        all_gnss = np.genfromtxt(args.gnsspath,
                                 converters={16: lambda x: fix_map.get(x, 0.0)})
        ten0 = all_gnss[0, 1:4].copy()

    all_odo = None
    if args.use_odo and args.odopath and os.path.isfile(args.odopath):
        all_odo = np.genfromtxt(args.odopath)
        all_odo = all_odo[np.fabs(all_odo[:, 0] - np.round(all_odo[:, 0])) < 0.001]
        rng = np.random.default_rng(12345)  # synthetic noise (demo_vio_whu.py:184-186)
        all_odo[:, 1:] += rng.standard_normal((all_odo.shape[0], 3)) * 0.05

    system.set_multisensor(
        all_imu, Tbc=WHU_TBC, all_gnss=all_gnss, all_odo=all_odo,
        all_stamp=load_stamps(args.imagestamp, 1.0),
        tbg=WHU_TBG, ten0=ten0, imu_noise=WHU_IMU_NOISE,
    )
    c = system.graph.coupled
    if args.use_gnss:
        c.init_pose_sigma = np.array([1.0, 1.0, 10.0, 10.0, 10.0, 10.0])
    else:
        c.init_pose_sigma = np.array([[0.1, 0.1, 0.0001, 0.0001, 0.0001, 0.0001],
                                      [1.0, 1.0, 0.0001, 10.0, 10.0, 10.0]])
    c.init_bias_sigma = np.array([1.0, 1.0, 1.0, 0.1, 0.1, 0.1])

    stream = image_stream(args.imagedir, args.calib, args.stride,
                          stamp_path=args.imagestamp, stamp_scale=1.0,
                          fisheye=False, target_area=320 * 640)
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
