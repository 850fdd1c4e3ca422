"""The asynchronous visual pipeline with every flag poll answering late, as
on the card when the host runs ahead of the device: no round's gate is
known when it is launched, so every round of every frame runs masked, and
its writes are undone where the frame was rejected or the keyframe culled.
The scene of ``test_torch_async_pipeline_culls.py`` (18 frames, culls), with
the motion gate rejecting frames 12 and 13 (``filter_thresh`` set to 0 for
them; the oracle's gate probe is 0), must give the port's synchronous
flow's result, as in ``test_torch_async_pipeline.py``."""

from dbaf_tpu_torch.utils.device import FlagPoll
from tests.test_torch_async_pipeline import assert_same, run_port
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)

KW = dict(n_frames=18, keyframe_thresh=0.12, slow=(10, 11, 14), thresh_at={12: 0.0, 14: -1.0})


class LatePoll(FlagPoll):
    """A FlagPoll whose answer never arrives before the rounds it gates."""

    def post(self, flag):
        self.posted += 1

    def value(self):
        return None


def test_masked_rounds_on_rejected_and_culled_frames_are_exact():
    a = run_port(True, poll=LatePoll, **KW)
    s = run_port(False, **KW)
    assert_same(a, s)
    st = a["stats"]
    rounds = 2 + 1  # iters1 + iters2
    assert st["masked_rounds"] == st["steps"] * rounds
    # the two rejected frames' rounds and each culled keyframe's rounds_b
    assert st["culls"] >= 1
    assert st["wasted_rounds"] == 2 * rounds + st["culls"]
    assert a["t1"] == s["t1"] and len(a["ts"]) == a["t1"]
    assert 12.0 not in a["ts"] and 13.0 not in a["ts"]
