"""The asynchronous coupled pipeline with a rollup inside it
(``test_coupled_async.py::test_async_coupled_rollup_in_pipeline``: 30
frames, ``rollup_start=20``, ``rollup_shift=8``): the step decides and applies
the rollup itself and the host replays it after its drain, so the pipeline
never drains for it.  Held against the port's synchronous flow and the JAX
package's async run at the bounds of ``test_torch_coupled_async.py``.
"""

from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_coupled_async import check_case, run_both


def test_async_matches_sync_and_jax_with_rollup():
    a, s, j = run_both(30, rollup_start=20)
    check_case(a, s, j, min_steps=3)
    assert a["rollups"] >= 1 and s["rollups"] == a["rollups"] == j["rollups"]
    # the pipeline stayed active across the rollup: one activation
    assert a["active_steps"] == a["steps"]
