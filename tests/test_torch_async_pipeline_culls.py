"""Keyframe culls inside the asynchronous visual pipeline
(``test_async_pipeline.py::test_async_matches_sync_with_culls``, 18
frames), held against the port's synchronous flow and the JAX package's
asynchronous run at the bounds of ``test_torch_async_pipeline.py``."""

from tests.test_torch_async_pipeline import check_scenario, run_all
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)


def test_async_matches_sync_and_jax_with_culls():
    a, s, j = run_all(n_frames=18, keyframe_thresh=0.12, slow=(10, 11, 14))
    assert s["t1"] < 18, "scene produced no culls; test is vacuous"
    check_scenario(a, s, j)
    assert a["stats"]["culls"] >= 1
