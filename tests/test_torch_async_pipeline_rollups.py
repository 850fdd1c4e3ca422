"""Two and more rollups inside the asynchronous visual pipeline
(``test_async_pipeline.py::test_async_matches_sync_with_rollups``, 26
frames, rollup 14/4), held against the port's synchronous flow and the JAX
package's asynchronous run at the bounds of
``test_torch_async_pipeline.py``."""

from tests.test_torch_async_pipeline import check_scenario, run_all
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)


def test_async_matches_sync_and_jax_with_rollups():
    a, s, j = run_all(n_frames=26, rollup=(14, 4))
    check_scenario(a, s, j)
    assert a["stats"]["rollups"] >= 2
