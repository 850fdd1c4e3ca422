"""The GraphAgg head and the upsample path of the port against the JAX
package: ``GraphAgg`` and ``DroidNet.update_with_agg`` on the same weights
(``from_jax_params``, and a reference-format checkpoint through
``load_reference_state_dict``), ``cvx_upsample``, ``GradientClip``'s
backward, ``CovisibleGraph.run_upsample`` with the dummy aggregator of
``tests/test_slam_e2e.py:275-297``, ``DBAFusion`` with ``upsample`` on
the synchronous flow, and the video's ``disps_up`` rows at every row move
(``test_torch_upsample_pipeline.py`` has the asynchronous pipeline
declining the flag).

Tolerances: f32 ``atol 1e-4`` (``test_torch_net.py``'s bound for the same
convolutions; eta, 0.01 x softplus, to 1e-5 as in
``tests/test_convert_checkpoint.py``); bf16 one bf16 ulp of the largest
value (``2^-7 max|ref|``: the port sums GraphAgg's per-frame means in f32
where the JAX package sums in bf16); the upsampling to 1e-5 (a softmax and
nine products in f32).
"""

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbaf_tpu.models.convert import convert_state_dict
from dbaf_tpu.models.net import DroidNet as JNet
from dbaf_tpu.models.net import GraphAgg as JAgg
from dbaf_tpu.models.net import _gc_bwd
from dbaf_tpu.train.unroll import cvx_upsample as j_cvx_upsample
from dbaf_tpu_torch.models.convert import from_jax_params, load_reference_state_dict
from dbaf_tpu_torch.models.net import DroidNet, GradientClip
from dbaf_tpu_torch.train.unroll import cvx_upsample, upsample_disp
from tests.test_golden_trace import synth_state_dict
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)

E, H, W, NF = 5, 6, 8, 4
II = np.asarray([0, 0, 1, 3, 3])  # frame 2 has no edge


@pytest.fixture(scope="module")
def params():
    return convert_state_dict(synth_state_dict())


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    net = np.tanh(rng.normal(size=(E, H, W, 128))).astype(np.float32)
    inp = np.maximum(rng.normal(size=(E, H, W, 128)), 0).astype(np.float32)
    corr = rng.normal(size=(E, H, W, 196)).astype(np.float32)
    flow = rng.normal(size=(E, H, W, 4)).astype(np.float32)
    return net, inp, corr, flow


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x).astype(np.float32)


def _check(a, b, name, dtype, atol=1e-4):
    a, b = _f32(a), _f32(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    tol = atol if dtype == "float32" else 2 ** -7 * float(np.abs(b).max())
    np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_with_agg_and_graphagg_match_jax(params, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jm = JNet(dtype=jdt)
    tm = DroidNet(dtype=tdt, device="cpu")
    tm.load_state_dict(from_jax_params(params))
    net, inp, corr, flow = _inputs()
    # the unroll hands the update operator its inputs in the network's dtype
    j = jm.apply({"params": params}, *(jnp.asarray(x).astype(jdt) for x in (net, inp, corr, flow)),
                 jnp.asarray(II), NF, method=jm.update_with_agg)
    t = tm.update_with_agg(*(torch.as_tensor(x) for x in (net, inp, corr, flow)),
                           torch.as_tensor(II), NF)
    for name, a, b in zip(("net", "delta", "weight", "eta", "upmask"), t, j):
        _check(a, b, name, dtype, atol=1e-5 if name == "eta" else 1e-4)
    assert t[3].dtype == torch.float32 and t[4].dtype == tdt

    # the head alone, with the serving signature (run_upsample's agg_fn)
    ja = JAgg(dtype=jdt).apply({"params": params["update"]["agg"]},
                               jnp.asarray(net).astype(jdt), jnp.asarray(II), NF)
    ta = tm.agg_fn(torch.as_tensor(net), torch.as_tensor(II), NF)
    _check(ta[0], ja[0], "agg eta", dtype, atol=1e-5)
    _check(ta[1], ja[1], "agg upmask", dtype)


def test_reference_checkpoint_carries_graphagg(tmp_path):
    """tests/test_convert_checkpoint.py:65-130 on the port: the torch
    replica's state_dict in the published key format, loaded with
    ``load_reference_state_dict``, gives the replica's eta and upmask."""
    from tests.test_convert_checkpoint import TDroid
    from tests.test_net import nchw

    rng = np.random.default_rng(0)
    tdroid = TDroid().eval()
    sd = OrderedDict(("module." + k, v) for k, v in tdroid.state_dict().items())
    state = load_reference_state_dict(sd)
    assert {k for k in state if k.startswith("update.agg.")} == {
        f"update.agg.{m}.{p}" for m in ("conv1", "conv2", "eta_0", "upmask_0")
        for p in ("weight", "bias")}
    tm = DroidNet(dtype=torch.float32, device="cpu")
    tm.load_state_dict(state)

    Ee, He, We = 4, 8, 10
    net = np.tanh(rng.normal(size=(Ee, He, We, 128))).astype(np.float32)
    inp = rng.normal(size=(Ee, He, We, 128)).astype(np.float32)
    corr = rng.normal(size=(Ee, He, We, 196)).astype(np.float32)
    flow = rng.normal(size=(Ee, He, We, 4)).astype(np.float32)
    ii = np.array([0, 0, 1, 2])
    with torch.no_grad():
        c = tdroid.update.corr_encoder(nchw(corr))
        f = tdroid.update.flow_encoder(nchw(flow))
        net_t = tdroid.update.gru(nchw(net), nchw(inp), c, f)
        eta_t, upmask_t = tdroid.update.agg(net_t, torch.tensor(ii))
        out = tm.update_with_agg(*(torch.as_tensor(x) for x in (net, inp, corr, flow)),
                                 torch.as_tensor(ii), 3)
    np.testing.assert_allclose(out[0].numpy(), np.moveaxis(net_t.numpy(), 1, -1), atol=1e-4)
    np.testing.assert_allclose(out[3].numpy(), np.moveaxis(eta_t.numpy(), 1, -1)[..., 0],
                               atol=1e-5)
    np.testing.assert_allclose(out[4].numpy(), np.moveaxis(upmask_t.numpy(), 1, -1), atol=1e-4)


def test_cvx_upsample_matches_jax_and_center_mask():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(2, 3, 4, 2)).astype(np.float32)
    mask = rng.normal(size=(2, 3, 4, 576)).astype(np.float32)
    up = cvx_upsample(torch.as_tensor(data), torch.as_tensor(mask))
    np.testing.assert_allclose(up.numpy(), np.asarray(j_cvx_upsample(jnp.asarray(data),
                                                                      jnp.asarray(mask))),
                               atol=1e-5)
    # tests/test_train.py:14: a mask on the centre tap (index 4, row-major)
    m = np.full((1, 3, 4, 9, 8, 8), -50.0, np.float32)
    m[:, :, :, 4] = 50.0
    up = cvx_upsample(torch.as_tensor(data[:1]), torch.as_tensor(m.reshape(1, 3, 4, 576)))
    assert up.shape == (1, 24, 32, 2)
    np.testing.assert_allclose(up[0, 8:16, 16:24, 0].numpy(),
                               float(data[0, 1, 2, 0]) * np.ones((8, 8)), atol=1e-4)
    # bf16 masks (the bf16 network's) are taken in the data's f32
    up16 = upsample_disp(torch.as_tensor(data[..., 0]), torch.as_tensor(mask).bfloat16())
    ref16 = j_cvx_upsample(jnp.asarray(data[..., :1]),
                           jnp.asarray(mask).astype(jnp.bfloat16))[..., 0]
    assert up16.dtype == torch.float32
    np.testing.assert_allclose(up16.numpy(), np.asarray(ref16),
                               atol=2 ** -7 * float(np.abs(data).max()))


def test_gradient_clip_backward_matches_jax():
    g = np.asarray([0.0, 0.005, -0.009, 0.0100001, -0.5, np.nan, 3.0, -0.01], np.float32)
    x = torch.zeros(g.shape, requires_grad=True)
    GradientClip.apply(x).backward(torch.as_tensor(g))
    (ref,) = _gc_bwd(None, jnp.asarray(g))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(ref))
    keep = np.abs(np.nan_to_num(g, nan=1.0)) <= 0.01
    np.testing.assert_array_equal(x.grad.numpy(), np.where(keep, g, 0.0))


def _oracle_system(upsample=True, async_on=False, n_frames=9):
    from dbaf_tpu_torch.slam.system import DBAFusion
    from tests.test_async_pipeline import make_scene
    from tests.test_torch_async_pipeline import INTR, INTR_FULL, frames, port_cfg, port_fns

    gt_poses, gt_disps = make_scene(n_frames, INTR)
    cfg = port_cfg(async_on)
    cfg.upsample = upsample
    feat_fn, ctx_fn, update_fn = port_fns(gt_poses, gt_disps, cfg.buffer)
    sysm = DBAFusion(cfg, device="cpu", feat_fn=feat_fn, ctx_fn=ctx_fn, update_fn=update_fn)
    for k, img in enumerate(frames(n_frames)):
        sysm.track(float(k), img, intrinsics=INTR_FULL)
    return sysm, cfg


def test_run_upsample_updates_damping_and_disps_up():
    """tests/test_slam_e2e.py:275-297: a dummy aggregator (eta 0.5, a
    uniform mask, so each 8 x 8 block is the 3 x 3 mean of the zero-padded
    disparities around its pixel)."""
    from tests.test_async_pipeline import H8, W8

    sysm, cfg = _oracle_system()
    g, v = sysm.graph, sysm.video
    assert g.n > 0 and g.agg_fn is None  # injected functions: no network head

    def dummy_agg(net, ii, num_frames):
        return (0.5 * torch.ones((num_frames, H8, W8)),
                torch.zeros((num_frames, H8, W8, 576)))

    damp0 = v.damping.clone()
    g.run_upsample(dummy_agg)
    frames = np.unique(g.ii)
    others = np.setdiff1d(np.arange(cfg.buffer), frames)
    damp = v.damping.numpy()
    np.testing.assert_allclose(damp[frames], 0.5, atol=1e-6)
    np.testing.assert_array_equal(damp[others], damp0.numpy()[others])
    up = v.disps_up.numpy()
    assert up.shape == (cfg.buffer, 8 * H8, 8 * W8)
    assert np.all(up[frames] > 0) and np.all(up[others] == 0)
    d = np.pad(v.disps.numpy(), ((0, 0), (1, 1), (1, 1)))
    mean3 = sum(d[:, dy:dy + H8, dx:dx + W8] for dy in range(3) for dx in range(3)) / 9.0
    np.testing.assert_allclose(up[frames], np.repeat(np.repeat(mean3, 8, 1), 8, 2)[frames],
                               atol=1e-5)


def _network_system(params, upsample=True, async_on=False, n_frames=12):
    from dbaf_tpu_torch.slam.system import DBAFusion
    from dbaf_tpu_torch.utils import config
    from tests.test_torch_int8_system import H as HT, W as WD, frame
    from tests.test_torch_system import golden_cfg

    cfg = golden_cfg(config)
    cfg.image_size = (HT, WD)
    cfg.upsample = upsample
    cfg.frontend.async_pipeline = async_on
    sysm = DBAFusion(cfg, params=params, device="cpu")
    intr = np.asarray([70.0, 70.0, WD / 2, HT / 2], np.float32)
    ups, active = [], []
    for k in range(n_frames):
        sysm.track(float(k), frame(k), intrinsics=intr)
        ups.append(None if sysm.video.disps_up is None else sysm.video.disps_up.clone())
        active.append(sysm._async is not None and sysm._async.active)
    return sysm, ups, active


def test_dbafusion_upsample_fills_disps_up(params):
    """The sync flow with the network's GraphAgg head: every frame with an
    edge has a finite full-resolution disps_up and GraphAgg's damping (the
    head applied to the edge states gives the same)."""
    from dbaf_tpu_torch.utils import config

    sysm, ups, _ = _network_system(from_jax_params(params))
    g, v = sysm.graph, sysm.video
    assert g.agg_fn is not None and v.disps_up.shape == (v.poses.shape[0], v.ht, v.wd)
    frames = np.unique(g.ii)
    up = v.disps_up.numpy()
    assert np.all(np.isfinite(up)) and np.all(np.abs(up[frames]).sum(axis=(1, 2)) > 0)
    damp = v.damping.clone()
    g.run_upsample(g.agg_fn)  # same edges and states: the same damping
    np.testing.assert_allclose(v.damping.numpy(), damp.numpy(), atol=1e-6)
    eta, _ = g.agg_fn(g.edges.net[:g.n], torch.as_tensor(g.ii), v.poses.shape[0])
    np.testing.assert_allclose(damp.numpy()[frames], eta.numpy()[frames], atol=1e-6)
    assert float(damp[frames].min()) > 0

    # weights without the head: the flag is taken, nothing is upsampled
    plain = {k: t for k, t in from_jax_params(params).items() if not k.startswith("update.agg.")}
    sysm2, ups2, _ = _network_system(plain, n_frames=9)
    assert sysm2.graph.agg_fn is None and float(sysm2.video.disps_up.abs().sum()) == 0
    # stereo with upsample (ported since): the right buffer and disps_up
    # both move with every row
    from dbaf_tpu_torch.slam.system import DBAFusion
    from tests.test_torch_system import golden_cfg

    cfg = golden_cfg(config)
    cfg.stereo = cfg.upsample = True
    v3 = DBAFusion(cfg, params=plain, device="cpu").video
    assert v3.fmaps_right.shape == v3.fmaps.shape and v3.fmaps_right.dtype == torch.bfloat16
    assert {"fmaps_right", "disps_up", "disps_sens"} <= set(v3._SHIFT_BUFFERS)


def test_disps_up_moves_with_every_row():
    """With ``upsample`` the video's disps_up rows move with the others at a
    cull (rm_keyframe), a rollup and the asynchronous steps' device moves,
    as ``_SHIFT_BUFFERS`` of the JAX package carries them
    (dbaf_tpu/slam/video.py:261-262)."""
    from dbaf_tpu_torch.slam.video import DepthVideo
    from tests.test_torch_async_pipeline import port_cfg

    cfg = port_cfg(False)
    cfg.upsample = True
    v = DepthVideo(cfg, device="cpu")
    B = cfg.buffer
    assert "disps_up" in v._SHIFT_BUFFERS and v.disps_up.shape == (B,) + cfg.image_size
    tag = torch.arange(B, dtype=torch.float32)
    v.disps_up.copy_(tag[:, None, None].expand_as(v.disps_up))
    v.disps.copy_(tag[:, None, None].expand_as(v.disps))
    v.counter = 10
    v.rm_keyframe(4)
    v.rollup(3)
    v.move_rows_device(torch.as_tensor([0]), torch.as_tensor([1]), torch.as_tensor(True))
    np.testing.assert_array_equal(v.disps_up[:, 0, 0].numpy(), v.disps[:, 0, 0].numpy())
    # rm_keyframe(4) copies slot 5 to 4, the rollup moves slot 4 to 1, the
    # device move row 1 to 0
    assert float(v.disps_up[0, 0, 0]) == 5.0
    plain = DepthVideo(port_cfg(False), device="cpu")
    assert plain.disps_up is None and "disps_up" not in plain._SHIFT_BUFFERS
