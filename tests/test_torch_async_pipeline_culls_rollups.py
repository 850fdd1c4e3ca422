"""The asynchronous visual pipeline with keyframe culls and rollups
interleaved (``test_async_pipeline.py::
test_async_matches_sync_with_culls_and_rollups``), held against the port's
synchronous flow and the JAX package's asynchronous run at the bounds of
``test_torch_async_pipeline.py``.  With this scene the culls (13 of the 20
frames after initialization) keep the keyframe count at or below
``rollup_start`` (14), so no rollup fires in either package: the oracle
maps a slot to the scene frame of its index, and after the first cull every
keyframe culls.  A run with culls and a rollup together, on an oracle keyed
by the scene frame, is ``test_torch_e2e_cull_rollup.py``; the rollups alone
are held in ``test_torch_async_pipeline_rollup.py`` and ``_rollups.py``."""

from tests.test_torch_async_pipeline import check_scenario, run_all
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)


def test_async_matches_sync_and_jax_with_culls_and_rollups():
    a, s, j = run_all(n_frames=28, keyframe_thresh=0.12, slow=(10, 11, 16, 21), rollup=(14, 4))
    assert s["t1"] < 28, "scene produced no culls; test is vacuous"
    check_scenario(a, s, j)
    assert a["stats"]["culls"] >= 1
