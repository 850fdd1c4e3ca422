"""The motion gate rejecting every frame inside the asynchronous visual
pipeline (bench.py's ``gateonly`` mode): ``filter_thresh`` is raised after
the pipeline has activated (frame 8), so frames 10-17 are rejected inside
it.  The keyframe count, the edges and their ages do not move, every frame
after the activation runs under ``NoHostRead``, and the result equals the port's
synchronous flow with the same threshold and a synchronous run of the first
10 frames alone."""

import numpy as np

from tests.test_torch_async_pipeline import assert_same, run_port
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)

KW = dict(n_frames=18, thresh_at={10: 1e9})


def test_rejected_frames_leave_the_state_as_it_was():
    a = run_port(True, **KW)
    s = run_port(False, **KW)
    b = run_port(False, n_frames=10)
    assert_same(a, s)
    assert_same(a, b)
    assert a["guarded"] == 9 and a["t1"] == 10
    assert a["stats"]["steps"] == 10 and a["stats"]["masked_rounds"] == 0
    np.testing.assert_array_equal(a["traj"], b["traj"])
