"""A rollup inside the asynchronous visual pipeline
(``test_async_pipeline.py::test_async_rollup_stays_in_pipeline``, 22
frames, rollup 14/4): the pipeline stays active across it, and the result
equals the port's synchronous flow and the JAX package's asynchronous run
(``test_torch_async_pipeline.py``'s bounds)."""

import numpy as np

from tests.test_torch_async_pipeline import check_scenario, run_all
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)


def test_async_rollup_stays_in_pipeline():
    a, s, j = run_all(n_frames=22, rollup=(14, 4))
    check_scenario(a, s, j)
    # run_port asserted the pipeline active at the end; the rollup ran in it
    assert a["stats"]["rollups"] >= 1 and a["stats"]["steps"] == 22 - 8
    assert a["t1"] <= 14 + 2 + 1  # rollup_start + lag + 1
    assert len(a["ii"]) > 0 and np.all(a["ii"] < a["t1"]) and np.all(a["jj"] < a["t1"])
    assert np.all(np.isfinite(a["poses"]))
