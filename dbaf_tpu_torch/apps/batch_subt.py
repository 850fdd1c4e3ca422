"""SubT handheld batch sweep (port of ``dbaf_tpu/apps/batch_subt.py``, the
reference's batch_subt.py:4-31).

Its tuned flags (max_factors=48, far_threshold=0.02,
translation_threshold=0.2, skip_edge=[-4,-5,-6]) live in
:func:`dbaf_tpu_torch.utils.config.subt_config`.

Usage:
    python -m dbaf_tpu_torch.apps.batch_subt --dataroot /data/subt \
        --weights droid.pth --calib calib/subt.txt \
        [--seqs Handheld1_Folder Handheld2_Folder]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

DEFAULT_SEQS = ["Handheld2_Folder"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--weights", required=True)
    ap.add_argument("--calib", required=True)
    ap.add_argument("--seqs", nargs="*", default=DEFAULT_SEQS)
    ap.add_argument("--outdir", default="results")
    ap.add_argument("--stride", type=int, default=8)
    ap.add_argument("--save_pkl", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.outdir, exist_ok=True)
    summary = {}
    for seq in args.seqs:
        seqdir = os.path.join(args.dataroot, seq)
        result = os.path.join(args.outdir, f"result_{seq}.txt")
        cmd = [
            sys.executable, "-m", "dbaf_tpu_torch.apps.demo_subt",
            "--imagedir", os.path.join(seqdir, "cam_0"),
            "--calib", args.calib,
            "--weights", args.weights,
            "--imupath", os.path.join(seqdir, "imu/imu_data.csv"),
            "--stride", str(args.stride),
            "--resultpath", result,
        ]
        if args.save_pkl:
            cmd += ["--save_pkl", "--pklpath",
                    os.path.join(args.outdir, f"{seq}.pkl")]
        print("[batch]", " ".join(cmd), flush=True)
        subprocess.run(cmd, check=False)
        summary[seq] = os.path.isfile(result)

    print(json.dumps(summary))


if __name__ == "__main__":
    main()
