"""The asynchronous coupled pipeline with keyframe culls inside it
(``test_coupled_async.py::test_async_matches_sync_coupled_with_culls``:
``keyframe_thresh=0.05, translation_threshold=0.35``), held against the
port's synchronous flow and the JAX package's async run at the bounds of
``test_torch_coupled_async.py``.

The pipeline here runs with its flag polls answering one poll late, as on
the card when the host runs ahead of the device: every LM loop runs a masked
iteration past its stopping point, and every keyframe's rounds after the
cull decision run before the decision is in, undone where it culls.  The
results must not move: masked work leaves the state as it was.

The bias reinitialization, 5 s after VI init in the frontend, is moved to
0.95 s after it (``move_reinit``), so it fires at frame 22, right after a
culled async step: the pipeline drains inside that frame with the cull still
pending, finishes it on the host, runs the keyframe on the synchronous flow
and enters the pipeline again.  Every trajectory row -- the decision-time
pose of each keyframe, the drained one included -- must then agree with the
synchronous flow's to 2e-2 m.  The JAX package's drain leaves the oracle's
slot-keyed ``id_map`` in its pre-cull rows, so its run here gets the port's
aux move (``test_torch_coupled_async._move_aux_at_drain``).
"""

import numpy as np

from dbaf_tpu_torch.utils.device import FlagPoll, host_wait
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_coupled_async import check_case, run_both

CULLS = dict(keyframe_thresh=0.05, translation_threshold=0.35)


class LatePoll(FlagPoll):
    """A FlagPoll whose posts land one poll late."""

    def post(self, flag):
        self.posted += 1
        self._posts.append(flag.clone())

    def value(self):
        if len(self._posts) > 1:  # all but the newest post have landed
            with host_wait():
                self._value = bool(self._posts[-2])
            del self._posts[:-1]
        return self._value


def test_async_matches_sync_and_jax_with_culls():
    a, s, j = run_both(26, port_kw=dict(poll=LatePoll), reinit_after=0.95, **CULLS)
    check_case(a, s, j, min_steps=5)
    assert a["culls"] >= 1  # culls happened inside the pipeline
    # the reinit drained the pipeline right after a culled step
    assert a["drains"] == [True] and a["active_steps"] < a["steps"]
    np.testing.assert_allclose(a["traj"][:, :3], s["traj"][:, :3], atol=2e-2)
    st = a["stats"]
    # the late polls ran masked work: LM iterations past done, and rounds
    # before their cull decision (undone on each culled keyframe)
    assert st["lm_launched"] > st["lm_iters"] and st["masked_rounds"] >= a["steps"] - a["culls"]
    assert st["wasted_rounds"] >= 1
