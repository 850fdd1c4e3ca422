"""The visual asynchronous pipeline declines ``cfg.upsample`` (a fault of
the reference recorded in ROADMAP Queue 3): ``DBAFusion`` with
``async_pipeline`` and ``upsample`` both on, the golden-trace configuration
at 64 x 128 and the seeded network of ``test_torch_graphagg.py``, keeps
running the GraphAgg head after the frame where the pipeline activates
without the flag."""

import torch
import pytest

from dbaf_tpu.models.convert import convert_state_dict
from dbaf_tpu_torch.models.convert import from_jax_params
from tests.test_golden_trace import synth_state_dict
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_graphagg import _network_system


@pytest.fixture(scope="module")
def params():
    return convert_state_dict(synth_state_dict())


def test_visual_pipeline_keeps_upsampling(params):
    """The JAX package's visual pipeline enters with ``upsample`` set and then
    stops updating damping and disps_up (dbaf_tpu/slam/async_pipeline.py:
    432-440).  The port's pipeline declines the flag: with async_pipeline and
    upsample both on, every keyframe step after the point where the
    pipeline activates without the flag still changes disps_up."""
    tp = from_jax_params(params)
    _, _, active = _network_system(tp, upsample=False, async_on=True)
    k_act = active.index(True)
    sysm, ups, active_up = _network_system(tp, upsample=True, async_on=True)
    assert not any(active_up)
    assert k_act + 2 < len(ups)
    for k in range(k_act, len(ups)):
        assert not torch.equal(ups[k], ups[k - 1]), k
