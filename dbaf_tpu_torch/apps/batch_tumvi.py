"""TUM-VI batch sweep and evaluation (port of ``dbaf_tpu/apps/batch_tumvi.py``).

Runs the demo across the room sequences with the tuned flag set (the
reference's batch_tumvi.py:20-43), then evaluates each trajectory.

Usage:
    python -m dbaf_tpu_torch.apps.batch_tumvi --dataroot /data/tumvi \
        --weights droid.pth --calib calib/tumvi.txt [--seqs room1 room2 ...]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

DEFAULT_SEQS = ["room1", "room2", "room3", "room4", "room5", "room6"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--weights", required=True)
    ap.add_argument("--calib", required=True)
    ap.add_argument("--seqs", nargs="*", default=DEFAULT_SEQS)
    ap.add_argument("--outdir", default="results")
    ap.add_argument("--stride", type=int, default=4)
    args = ap.parse_args(argv)

    os.makedirs(args.outdir, exist_ok=True)
    summary = {}
    for seq in args.seqs:
        datadir = os.path.join(args.dataroot, f"dataset-{seq}_512_16")
        result = os.path.join(args.outdir, f"result_{seq}.txt")
        cmd = [
            sys.executable, "-m", "dbaf_tpu_torch.apps.demo_tumvi",
            "--datadir", datadir,
            "--calib", args.calib,
            "--weights", args.weights,
            "--imupath", os.path.join(datadir, "mav0/imu0/data.csv"),
            "--stride", str(args.stride),
            "--resultpath", result,
        ]
        print("[batch]", " ".join(cmd), flush=True)
        subprocess.run(cmd, check=False)

        gt = os.path.join(datadir, "mav0/mocap0/data.csv")
        if os.path.isfile(gt) and os.path.isfile(result):
            from ..data.streams import load_mocap_gt
            from ..eval.evaluate import evaluate
            from ..eval.traj_io import read_tum

            res = evaluate(read_tum(result), load_mocap_gt(gt))
            summary[seq] = res["ate_rmse"]
            print(f"[batch] {seq}: ATE RMSE {res['ate_rmse']:.4f} m", flush=True)

    print(json.dumps(summary))


if __name__ == "__main__":
    main()
