"""Trajectory evaluation CLI (port of ``dbaf_tpu/eval/evaluate.py``).

The reference's protocol (evaluation_scripts/evaluate_tumvi.py:156-178):
associate by timestamp, Umeyama-align on the starting segment (up to the
first ground-truth gap over 100 s; scale only for visual-only runs), then
the metric-scale ATE over the whole overlap.

Usage:
    python -m dbaf_tpu_torch.eval.evaluate est.txt gt.txt [--scale] [--max_dt 0.01]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .ate import associate, umeyama
from .traj_io import read_tum


def evaluate(est: np.ndarray, ref: np.ndarray, correct_scale: bool = False,
             max_dt: float = 0.01, gap: float = 100.0) -> dict:
    """est, ref: TUM rows (N, 8+)."""
    ei, ri = associate(est[:, 0], ref[:, 0], max_dt)
    if len(ei) < 3:
        return {"ate_rmse": float("inf"), "matched": int(len(ei))}
    p_est = est[ei, 1:4]
    p_ref = ref[ri, 1:4]
    t_ref = ref[ri, 0]

    # the starting segment, up to the first large ground-truth gap
    gaps = np.nonzero(np.diff(t_ref) > gap)[0]
    n_align = max(int(gaps[0]) - 1 if len(gaps) else len(p_ref), 3)
    s, R, t = umeyama(p_est[:n_align], p_ref[:n_align], with_scale=correct_scale)
    aligned = p_est @ (s * R).T + t

    # second pass: SE3 only over the whole overlap, at metric scale
    _, R2, t2 = umeyama(aligned, p_ref, with_scale=False)
    err = np.linalg.norm(aligned @ R2.T + t2 - p_ref, axis=1)
    return {
        "ate_rmse": float(np.sqrt(np.mean(err ** 2))),
        "ate_mean": float(err.mean()),
        "ate_max": float(err.max()),
        "matched": int(len(ei)),
        "align_scale": float(s),
        "n_to_align": int(n_align),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("est")
    ap.add_argument("ref")
    ap.add_argument("--scale", action="store_true",
                    help="allow scale in the first alignment (visual-only)")
    ap.add_argument("--max_dt", type=float, default=0.01)
    args = ap.parse_args(argv)
    out = evaluate(read_tum(args.est), read_tum(args.ref), args.scale, args.max_dt)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
