"""``save_pkl`` on the asynchronous coupled pipeline with culls inside it
(``tests/test_flagship_outputs.py::test_save_pkl_flagship_with_culls``,
slow in the JAX package: rollup 22/8, keyframe threshold 0.05, translation
threshold 0.35), port-async against port-sync under the assertions of
``test_torch_save_pkl_coupled.py``: culled keyframes are never archived,
and the export sequence matches the synchronous flow's when culls
interleave with rollups.  The JAX test runs 36 frames; here six culls
inside the pipeline precede the rollup (frame 28), and 31 frames keep the
file inside its time budget with two async steps after it."""

from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_save_pkl_coupled import check_pair, run_pair


def test_save_pkl_coupled_pipeline_with_culls():
    n = 31
    a, s = run_pair(n, keyframe_thresh=0.05, translation_threshold=0.35)
    ca = check_pair(a, s, n)
    assert ca.culls >= 1, ca.culls
