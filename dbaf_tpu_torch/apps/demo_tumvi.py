"""TUM-VI visual-inertial demo (port of ``dbaf_tpu/apps/demo_tumvi.py``,
the reference's demo_vio_tumvi.py).

Usage:
    python -m dbaf_tpu_torch.apps.demo_tumvi --datadir .../dataset-room1_512_16 \\
        --calib calib/tumvi.txt --weights droid.pth --imupath .../imu.csv \\
        [--resultpath traj.txt] [--gtpath gt.csv] [--enable_h5 --h5path f.h5]

The images need OpenCV (or the HDF5 cache, h5py); the system runs on the
card.  ``setup`` does everything ``main`` does before the first frame.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# TUM-VI camera->IMU extrinsic (demo_vio_tumvi.py:184-189, inverted there
# into body<-camera)
TUMVI_TIC = np.array(
    [
        [-0.9995250378696743, 0.029615343885863205, -0.008522328211654736, 0.04727988224914392],
        [0.0075019185074052044, -0.03439736061393144, -0.9993800792498829, -0.047443232143367084],
        [-0.02989013031643309, -0.998969345370175, 0.03415885127385616, -0.0681999605066297],
        [0.0, 0.0, 0.0, 1.0],
    ]
)
# inflated IMU noise (demo_vio_tumvi.py:193)
TUMVI_IMU_NOISE = [0.0003924 * 25, 0.000205689024915 * 25, 0.004905 * 10,
                   0.000001454441043 * 5000]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--datadir", required=True)
    ap.add_argument("--calib", required=True)
    ap.add_argument("--weights", required=True)
    ap.add_argument("--selftest", action="store_true",
                    help="validate the checkpoint conversion and exit")
    ap.add_argument("--imupath", required=True)
    ap.add_argument("--stride", type=int, default=4)
    ap.add_argument("--resultpath", default="result_tumvi.txt")
    ap.add_argument("--gtpath", default=None)
    ap.add_argument("--enable_h5", action="store_true")
    ap.add_argument("--h5path", default=None)
    ap.add_argument("--visual_only", action="store_true")
    ap.add_argument("--save_pkl", action="store_true")
    ap.add_argument("--pklpath", default="reconstruction_tumvi.pkl")
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--monitor", default="", metavar="DIR",
                    help="dump the live-monitor panels and debug views"
                         " as PNGs into DIR (dbaf_frontend.py:76-83)")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace, device=None):
    """The system with the TUM-VI preset and its sensors, and the frame
    stream (not yet read).  ``device`` defaults to the card."""
    from ..data.hdf5 import h5_stream
    from ..data.streams import load_imu, load_stamps, tumvi_stream
    from ..slam.system import DBAFusion
    from ..utils.config import tumvi_config

    cfg = tumvi_config(weights_path=args.weights, save_pkl=args.save_pkl)
    cfg.frontend.monitor_dir = args.monitor
    system = DBAFusion(cfg, device=device)

    system.set_multisensor(
        load_imu(args.imupath, gyro_unit="rad"),
        Tbc=np.linalg.inv(TUMVI_TIC),
        all_stamp=load_stamps(os.path.join(args.datadir, "mav0/cam0/data.csv")),
        imu_noise=TUMVI_IMU_NOISE,
        visual_only=args.visual_only,
    )
    system.graph.coupled.init_bias_sigma = np.array([1.0] * 6)

    if args.enable_h5:
        stream = h5_stream(args.h5path)
    else:
        stream = tumvi_stream(args.datadir, args.calib, args.stride)
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
