"""WHU batch: the three fusion modes (VIO+ZUPT / +wheel / +GNSS) of the
reference's batch_whu.py:5-85 (port of ``dbaf_tpu/apps/batch_whu.py``).

Usage:
    python -m dbaf_tpu_torch.apps.batch_whu --imagedir ... --imagestamp ... \
        --calib calib/whu.txt --weights droid.pth --imupath ... \
        [--gnsspath ...] [--odopath ...]
"""

from __future__ import annotations

import argparse
import subprocess
import sys

MODES = {
    "vio_zupt": ["--use_zupt"],
    "vio_wheel": ["--use_odo"],
    "vio_gnss": ["--use_gnss"],
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--imagedir", required=True)
    ap.add_argument("--imagestamp", required=True)
    ap.add_argument("--calib", required=True)
    ap.add_argument("--weights", required=True)
    ap.add_argument("--imupath", required=True)
    ap.add_argument("--gnsspath", default=None)
    ap.add_argument("--odopath", default=None)
    ap.add_argument("--outdir", default="results")
    args = ap.parse_args(argv)

    for mode, flags in MODES.items():
        if "--use_gnss" in flags and not args.gnsspath:
            continue
        if "--use_odo" in flags and not args.odopath:
            continue
        cmd = [
            sys.executable, "-m", "dbaf_tpu_torch.apps.demo_whu",
            "--imagedir", args.imagedir,
            "--imagestamp", args.imagestamp,
            "--calib", args.calib,
            "--weights", args.weights,
            "--imupath", args.imupath,
            "--resultpath", f"{args.outdir}/result_whu_{mode}.txt",
        ] + flags
        if args.gnsspath:
            cmd += ["--gnsspath", args.gnsspath]
        if args.odopath:
            cmd += ["--odopath", args.odopath]
        print("[batch]", " ".join(cmd), flush=True)
        subprocess.run(cmd, check=False)


if __name__ == "__main__":
    main()
