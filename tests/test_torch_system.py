"""The port's DBAFusion end to end on the CPU: the 16-frame golden trace of
``test_golden_trace.py`` (same config, weights and frames), and a source
scan that keeps the port free of JAX.

Bounds.  ``test_golden_trace.py:129-143`` holds the JAX package to its own
recorded trace: fmap0_slice atol 1e-4, fmap0_absmean rtol 1e-4, traj /
disp_mean / disp_std atol 5e-3.  Those bounds need bit-equal bf16 rounding,
and a bf16 network cannot give that across frameworks: every convolution,
norm and activation rounds to bf16, and a sum taken in another order flips
a rounding now and then; the flips compound through the encoder's layers
and the random-weight BA chain.  The JAX package shows the same thing on
its own: rerun with XLA's excess bf16 precision turned off
(``XLA_FLAGS=--xla_allow_excess_precision=false``, a pure change of rounding
points), it misses its recorded trace by fmap0_slice 0.043, fmap0_absmean
3.0e-4 (relative), traj 7.8e-3, disp_mean 0.165 and disp_std 0.139.  The
port's bf16 trace misses it by 0.067, 2.2e-4, 7.5e-3 to 7.8e-3, 0.23 to 0.27
and 0.15 to 0.27 (torch on 1, 3 and 8 CPU threads: the thread count changes
the order of the CPU sums too).

So the bf16 trace is held to bounds that cover that spread about twice
(traj atol 2e-2; disp_mean / disp_std atol 0.6, against values up to 18;
fmap0_slice 16 bf16 ulps of its largest entry; fmap0_absmean rtol 1e-3),
and the whole trace is also
held against the JAX DBAFusion with an f32 network injected through
feat_fn / ctx_fn / update_fn on both sides, where the network adds no
rounding of its own: traj atol 1e-3 (measured 2.3e-4), disp_mean atol
5e-2 (measured 0.017), disp_std atol 3e-2 (measured 8.4e-3).  The
remaining f32 spread comes from the bf16 correlation volume and bf16 state
buffers that both sides keep, whose f32 sums run in another order.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbaf_tpu.models.convert import convert_state_dict
from tests.test_golden_trace import DATA, H, W, frame, synth_state_dict

N_FRAMES = 16
INTR = np.asarray([70.0, 70.0, W / 2, H / 2], np.float32)


def golden_cfg(m):
    return m.DBAFusionConfig(
        image_size=(H, W), buffer=24,
        graph=m.GraphConfig(
            max_factors=32, edge_capacity=48, inactive_capacity=48,
            frontend_window=5, frontend_radius=2, frontend_nms=1,
            frontend_thresh=20.0, max_age=25, inac_range=3,
            far_threshold=-1.0, mask_threshold=-1.0),
        frontend=m.FrontendConfig(
            warmup=8, keyframe_thresh=-1.0, filter_thresh=0.0,
            iters1=2, iters2=1, init_iters=4, rollup_start=1000,
            rollup_shift=8, active_window=12),
        ba=m.BAConfig(window=20, iters=2))


def _summary(system):
    for k in range(N_FRAMES):
        system.track(float(k), frame(k), intrinsics=INTR)
    traj = np.asarray(system.terminate(), np.float32)
    t1 = system.frontend.t1
    disps, fmap0 = system.video.disps[:t1], system.video.fmaps[0]
    if isinstance(disps, torch.Tensor):
        disps, fmap0 = disps.numpy(), fmap0.float().numpy()
    disps, fmap0 = np.asarray(disps), np.asarray(fmap0, np.float32)
    return {
        "traj": traj,
        "disp_mean": disps.mean(axis=(1, 2)),
        "disp_std": disps.std(axis=(1, 2)),
        "fmap0_absmean": np.abs(fmap0).mean(),
        "fmap0_slice": fmap0[2, 3, :8],
    }


@pytest.fixture(scope="module")
def params():
    return convert_state_dict(synth_state_dict())


def _port(params, dtype):
    from dbaf_tpu_torch.models.convert import from_jax_params
    from dbaf_tpu_torch.slam.system import DBAFusion
    from dbaf_tpu_torch.utils import config

    return DBAFusion(golden_cfg(config), params=from_jax_params(params), device="cpu",
                     dtype=dtype)


def test_bf16_trace_against_golden(params):
    got = _summary(_port(params, torch.bfloat16))
    ref = np.load(os.path.join(DATA, "golden_trace.npz"))
    assert got["traj"].shape == ref["traj"].shape
    assert np.all(np.isfinite(got["traj"]))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref["fmap0_slice"]).max())) - 7)
    np.testing.assert_allclose(got["fmap0_slice"], ref["fmap0_slice"], atol=16 * ulp)
    np.testing.assert_allclose(got["fmap0_absmean"], ref["fmap0_absmean"], rtol=1e-3)
    np.testing.assert_allclose(got["traj"], ref["traj"], atol=2e-2)
    np.testing.assert_allclose(got["disp_mean"], ref["disp_mean"], atol=0.6)
    np.testing.assert_allclose(got["disp_std"], ref["disp_std"], atol=0.6)


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


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(root, "dbaf_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|dbaf_tpu(?!_torch))\b", re.M)
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad
    assert len(files) > 10


def test_entry_points_need_a_card_or_an_explicit_cpu(params):
    from dbaf_tpu_torch.models.convert import from_jax_params
    from dbaf_tpu_torch.models.net import DroidNet
    from dbaf_tpu_torch.slam.system import DBAFusion
    from dbaf_tpu_torch.slam.video import DepthVideo
    from dbaf_tpu_torch.utils import config
    from dbaf_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    assert DepthVideo(golden_cfg(config), "cpu").poses.device.type == "cpu"
    if not torch.cuda.is_available():
        for make in (lambda: resolve_device(None), lambda: DroidNet(),
                     lambda: DepthVideo(golden_cfg(config)),
                     lambda: DBAFusion(golden_cfg(config), params=from_jax_params(params))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
