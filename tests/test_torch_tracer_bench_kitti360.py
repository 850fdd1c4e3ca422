"""A small ``--trace 1`` run of ``kitti360-vio.urban`` on the CPU: the cell's
configuration and traffic at 64 x 128 (an 8 x 16 feature grid, the keyframe
distance scaled to it), 160 frames and the window opened at VI
initialization, as ``perfbench/tests/tiny.py`` sizes the other cells, with
the kernels' plain versions.  ``correct`` comes out true, the trajectory
is compared, and the two counters the cell adds read above 0: the
short-baseline mask cuts edges in the slow phases of the drive
(``mask_share``) and the asynchronous step culls keyframes there
(``cull_share``)."""

import math
import time

import torch

from dbaf_tpu_torch.utils import profiling

SMALL = {"config.dbafusion.image_size": [64, 128],
         "config.dbafusion.frontend.keyframe_thresh": 3.5 * 128 / 1032,
         "traffic.frames": 160, "config.window.opens_after": ["vi_init"]}
SEED = 2 ** 31 + 977


def test_kitti360_traced_run_reports_masks_and_culls():
    from perfbench import harness

    torch.set_num_threads(1)
    profiling.TRACER.reset()
    try:
        result = harness.run_cell("kitti360-vio.urban", SEED, 12.0, True, time.perf_counter(),
                                  device="cpu", overrides=SMALL)
    finally:
        profiling.set_tracing(False)
        profiling.TRACER.reset()
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert result["correct"], result["compared"]
    assert "traj_m" in result["compared"] and result["_window"]["traj_rows"] >= 3
    for name in ("mask_share", "cull_share"):
        assert math.isfinite(m[name]) and 0 < m[name] <= 100, (name, m[name])
    assert "a" in result["_window"]["path"].lower()  # the asynchronous coupled step ran
