"""The port's DBAFusion end to end on the CPU with an f32 network: the
16-frame golden trace of ``test_golden_trace.py`` (helpers in
``test_torch_system.py``) against the JAX DBAFusion with the same f32
network injected through feat_fn / ctx_fn / update_fn on both sides, where
the network adds no rounding of its own: traj atol 1e-3 (measured 2.3e-4),
disp_mean atol 5e-2 (measured 0.017), disp_std atol 3e-2 (measured
8.4e-3).  The remaining f32 spread comes from the bf16 correlation volume
and bf16 state buffers that both sides keep, whose f32 sums run in another
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_system import _port, _summary, golden_cfg, params  # noqa: F401  (fixture)


def test_f32_network_trace_against_jax(params):
    from dbaf_tpu.models.net import DroidNet as JNet
    from dbaf_tpu.slam.system import DBAFusion as JSystem
    from dbaf_tpu.utils import config as jconfig

    jm = JNet(dtype=jnp.float32)
    feat = jax.jit(lambda im: jm.apply({"params": params}, im, method=jm.features_only))
    ctx = jax.jit(lambda im: jm.apply({"params": params}, im, method=jm.context_only))

    @jax.jit
    def update(net, inp, corr, motn):
        n, d, w, _, _ = jm.apply({"params": params}, None, net, inp, corr, motn)
        return n.astype(net.dtype), d, w  # the edge state stays bf16

    ref = _summary(JSystem(golden_cfg(jconfig), feat_fn=feat, ctx_fn=ctx,
                           update_fn=lambda n, i, c, m, ii, jj, aux: update(n, i, c, m)))
    got = _summary(_port(params, torch.float32))
    assert got["traj"].shape == ref["traj"].shape
    np.testing.assert_allclose(got["fmap0_slice"], ref["fmap0_slice"], atol=1e-4)
    np.testing.assert_allclose(got["traj"], ref["traj"], atol=1e-3)
    np.testing.assert_allclose(got["disp_mean"], ref["disp_mean"], atol=5e-2)
    np.testing.assert_allclose(got["disp_std"], ref["disp_std"], atol=3e-2)
