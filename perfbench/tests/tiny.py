"""A cell at a size the CPU runs in about a minute: the same configuration
and traffic with a 64 x 128 frame (an 8 x 16 feature grid, which every
pyramid level divides), the keyframe distance scaled to the grid, a
shorter scene, and the window opened at VI initialization (the later
start-up events take a minute more each on the CPU)."""

import time

SMALL = {
    "tumvi-vio.handheld": {"config.dbafusion.image_size": [64, 128],
                           "config.dbafusion.frontend.keyframe_thresh": 3.5 * 128 / 512,
                           "traffic.frames": 160, "config.window.opens_after": ["vi_init"]},
    "whu-ms.drive": {"config.dbafusion.image_size": [64, 128],
                     "config.dbafusion.frontend.keyframe_thresh": 3.5 * 128 / 640,
                     "traffic.frames": 160, "config.window.opens_after": ["vi_init"]},
}
CELLS = tuple(SMALL)
SEED = 2 ** 31 + 977  # more than 32 signed bits hold


def run_small(cell, seconds=3.0, trace=False, root=None, overrides=None, seed=SEED, fault=None):
    import torch

    from perfbench import harness

    torch.set_num_threads(1)  # one thread: the CPU's sums in one order
    ov = dict(SMALL[cell])
    ov.update(overrides or {})
    kw = {} if root is None else {"root": root}
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(), device="cpu",
                            overrides=ov, fault=fault, **kw)


def main(argv=None):
    """``python -m perfbench.tests.tiny --workload <cell>``: one small run on
    the CPU with the kernels' plain versions; prints the result line."""
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=CELLS, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result = run_small(args.workload, args.seconds, bool(args.trace))
    for key in [k for k in result if k.startswith("_")]:
        result.pop(key)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
