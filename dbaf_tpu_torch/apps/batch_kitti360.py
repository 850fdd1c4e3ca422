"""KITTI-360 batch sweep over the eight benchmark drives (port of
``dbaf_tpu/apps/batch_kitti360.py``, the reference's batch_kitti360.py:4-29).

The tuned flag set there (max_factors=48, far_threshold=-1,
translation_threshold=0.5, mask_threshold=1.0, skip_edge=[-4,-5,-6]) lives
in :func:`dbaf_tpu_torch.utils.config.kitti360_config`, so this script only
supplies per-drive paths.

Usage:
    python -m dbaf_tpu_torch.apps.batch_kitti360 --dataroot /data/kitti360 \
        --weights droid.pth --calib calib/kitti_360.txt [--drives 0000 0002]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

DEFAULT_DRIVES = ["0000", "0002", "0003", "0004", "0005", "0006", "0009", "0010"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--weights", required=True)
    ap.add_argument("--calib", required=True)
    ap.add_argument("--drives", nargs="*", default=DEFAULT_DRIVES)
    ap.add_argument("--outdir", default="results")
    ap.add_argument("--stride", type=int, default=2)
    ap.add_argument("--save_pkl", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.outdir, exist_ok=True)
    summary = {}
    for drive in args.drives:
        seqdir = os.path.join(args.dataroot, f"2013_05_28_drive_{drive}_sync")
        result = os.path.join(args.outdir, f"result_{drive}.txt")
        cmd = [
            sys.executable, "-m", "dbaf_tpu_torch.apps.demo_kitti360",
            "--imagedir", os.path.join(seqdir, "image_00/data_rgb"),
            "--calib", args.calib,
            "--weights", args.weights,
            "--imupath", os.path.join(seqdir, "imu.txt"),
            "--stride", str(args.stride),
            "--resultpath", result,
        ]
        gt = os.path.join(seqdir, "gt_local.txt")
        if os.path.isfile(gt):
            cmd += ["--gtpath", gt]
        if args.save_pkl:
            cmd += ["--save_pkl", "--pklpath",
                    os.path.join(args.outdir, f"{drive}.pkl")]
        print("[batch]", " ".join(cmd), flush=True)
        subprocess.run(cmd, check=False)

        if os.path.isfile(gt) and os.path.isfile(result):
            from ..eval.evaluate import evaluate
            from ..eval.traj_io import read_tum

            res = evaluate(read_tum(result), read_tum(gt))
            summary[drive] = res["ate_rmse"]
            print(f"[batch] {drive}: ATE RMSE {res['ate_rmse']:.4f} m",
                  flush=True)

    print(json.dumps(summary))


if __name__ == "__main__":
    main()
