"""Port parity for the covisibility graph: one fused keyframe update step
against the JAX package's ``make_update_kernel`` on the same state, and the
native edge selection's output order.

The state (poses, disparities, feature buffers, edges) is made with numpy
from a seed; both sides run the same f32 network weights through
``update_fn`` (from ``test_golden_trace.synth_state_dict``), so the network
adds no bf16 rounding of its own.  Tolerance ``atol 1e-3`` on poses, targets
and weights and ``2e-3`` on disparities after 3+1 rounds of 2 Gauss-Newton
iterations: both sides round the correlation volume and the edge hidden
state to bf16, and their f32 sums run in another order, so a value that
sits on a bf16 rounding boundary can round the other way; the step's
Schur solve amplifies those ulp-level changes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbaf_tpu.models.convert import convert_state_dict
from dbaf_tpu.models.net import DroidNet as JNet
from dbaf_tpu.ops import lie as jl
from dbaf_tpu.slam import graph as jg
from dbaf_tpu.slam.video import DepthVideo as JVideo
from dbaf_tpu.utils import config as jcfg
from dbaf_tpu_torch.models.convert import from_jax_params
from dbaf_tpu_torch.models.net import DroidNet
from dbaf_tpu_torch.slam import graph as tg
from dbaf_tpu_torch.slam.video import DepthVideo as TVideo
from dbaf_tpu_torch.utils import config as tcfg
from tests.test_golden_trace import synth_state_dict

HT, WD = 48, 64
B, WINDOW = 12, 10


def _cfg(m, i_cap=8):
    return m.DBAFusionConfig(
        image_size=(HT, WD), buffer=B,
        graph=m.GraphConfig(max_factors=16, edge_capacity=16, inactive_capacity=i_cap,
                            frontend_thresh=20.0, far_threshold=-1.0, mask_threshold=-1.0,
                            skip_edge=(-4, -5, -6)),
        frontend=m.FrontendConfig(keyframe_thresh=-1.0),
        ba=m.BAConfig(window=WINDOW, iters=2))


@pytest.fixture(scope="module")
def nets():
    params = convert_state_dict(synth_state_dict())
    jm = JNet(dtype=jnp.float32)

    @jax.jit
    def j_update(net, inp, corr, motn):
        n, d, w, _, _ = jm.apply({"params": params}, None, net, inp, corr, motn)
        return n.astype(net.dtype), d, w

    def j_update_fn(net, inp, corr, motn, ii, jj, aux):
        return j_update(net, inp, corr, motn)

    tm = DroidNet(dtype=torch.float32, device="cpu")
    tm.load_state_dict(from_jax_params(params))
    return j_update_fn, tm.update_step


def _state(seed, n_kf=8):
    rng = np.random.default_rng(seed)
    h8, w8 = HT // 8, WD // 8
    xi = np.zeros((B, 6), np.float32)
    xi[:n_kf, :3] = 0.05 * np.arange(n_kf)[:, None] * np.asarray([1.0, 0.2, 0.1])
    xi[:n_kf] += 0.01 * rng.normal(size=(n_kf, 6))
    poses = np.asarray(jl.se3_exp(jnp.asarray(xi)))
    disps = (0.5 + 0.3 * rng.random((B, h8, w8))).astype(np.float32)
    feats = lambda: rng.normal(size=(B, h8, w8, 128)).astype(np.float32)
    fmaps, nets_, inps = feats(), np.tanh(feats()), np.maximum(feats(), 0)
    ii, jj = np.meshgrid(np.arange(n_kf), np.arange(n_kf), indexing="ij")
    keep = (np.abs(ii - jj) >= 1) & (np.abs(ii - jj) <= 2)
    ii, jj = ii[keep][:14], jj[keep][:14]
    ii_i, jj_i = np.asarray([0, 1, 2]), np.asarray([2, 3, 0])
    return dict(poses=poses, disps=disps, fmaps=fmaps, nets=nets_, inps=inps,
                ii=ii, jj=jj, ii_i=ii_i, jj_i=jj_i, n_kf=n_kf,
                intr=np.asarray([40.0, 40.0, WD / 16, HT / 16], np.float32),
                target=(rng.uniform(0, 8, size=(16, h8, w8, 2))).astype(np.float32),
                weight=rng.uniform(0, 1, size=(16, h8, w8, 2)).astype(np.float32),
                t_inac=(rng.uniform(0, 8, size=(8, h8, w8, 2))).astype(np.float32),
                w_inac=rng.uniform(0, 1, size=(8, h8, w8, 2)).astype(np.float32),
                e_net=np.tanh(rng.normal(size=(16, h8, w8, 128))).astype(np.float32))


def _pad(a, n):
    out = np.zeros(n, np.int64)
    out[: len(a)] = a
    return out


def test_fused_keyframe_step_matches_jax(nets):
    j_update_fn, t_update_fn = nets
    s = _state(3)
    n_kf = s["n_kf"]
    t0, t1 = 1, n_kf
    s0 = max(0, t1 - WINDOW)
    e_mask = np.arange(16) < len(s["ii"])
    i_mask = np.arange(8) < len(s["ii_i"])
    bf = jnp.bfloat16
    kern = jg.make_update_kernel(_cfg(jcfg), j_update_fn, 16, 8)
    jres, jtraj = kern(
        jnp.asarray(s["poses"]), jnp.asarray(s["disps"]), jnp.zeros_like(s["disps"]),
        jnp.full(s["disps"].shape, 1e-6, jnp.float32), jnp.asarray(s["intr"]),
        jnp.asarray(s["fmaps"], bf), jnp.asarray(s["inps"], bf), None,
        jnp.asarray(s["e_net"], bf), jnp.asarray(s["target"]), jnp.asarray(s["weight"]),
        jnp.asarray(_pad(s["ii"], 16), jnp.int32), jnp.asarray(_pad(s["jj"], 16), jnp.int32),
        jnp.asarray(e_mask), jnp.asarray(s["t_inac"]), jnp.asarray(s["w_inac"]),
        jnp.asarray(_pad(s["ii_i"], 8), jnp.int32), jnp.asarray(_pad(s["jj_i"], 8), jnp.int32),
        jnp.asarray(i_mask), jnp.asarray(t0, jnp.int32), jnp.asarray(t1, jnp.int32),
        jnp.asarray(s0, jnp.int32), jnp.asarray(False), {},
        jnp.asarray(3, jnp.int32), jnp.asarray(1, jnp.int32),
        iters=2, use_inactive=True, do_ba=True, use_sens=False, seed_next=False, mega=True)

    cfg = _cfg(tcfg)
    dev = torch.device("cpu")
    v = TVideo(cfg, dev)
    v.poses.copy_(torch.tensor(s["poses"]))
    v.disps.copy_(torch.tensor(s["disps"]))
    v.fmaps.copy_(torch.tensor(s["fmaps"]))
    v.inps.copy_(torch.tensor(s["inps"]))
    v.intrinsics = torch.tensor(s["intr"])
    edges = tg.EdgeArrays(16, HT // 8, WD // 8, dev)
    edges.net.copy_(torch.tensor(s["e_net"]))
    edges.target.copy_(torch.tensor(s["target"]))
    edges.weight.copy_(torch.tensor(s["weight"]))
    step = tg.UpdateStep(cfg, t_update_fn)
    t = lambda a: torch.tensor(np.asarray(a))
    tres = step(v, edges, t(_pad(s["ii"], 16)), t(_pad(s["jj"], 16)), t(e_mask),
                t(s["t_inac"]), t(s["w_inac"]), t(_pad(s["ii_i"], 8)), t(_pad(s["jj_i"], 8)),
                t(i_mask), t0, t1, s0, 3, 1, 2, True, True)

    np.testing.assert_allclose(v.poses.numpy(), np.asarray(jres.poses), atol=1e-3)
    np.testing.assert_allclose(v.disps.numpy(), np.asarray(jres.disps), atol=2e-3)
    np.testing.assert_allclose(edges.target.numpy(), np.asarray(jres.edges.target), atol=1e-3)
    np.testing.assert_allclose(edges.weight.numpy(), np.asarray(jres.edges.weight), atol=1e-3)
    np.testing.assert_allclose(tres.traj_row.numpy(), np.asarray(jtraj), atol=1e-3)
    jp_, tp_ = np.asarray(jres.host_pack), tres.host_pack.numpy()
    assert jp_[0] == tp_[0]  # the cull decision
    np.testing.assert_allclose(tp_[1:], jp_[1:], rtol=1e-2, atol=1e-2)


def test_proximity_edges_match_jax_order():
    s = _state(4, n_kf=9)
    jcf, tcf = _cfg(jcfg, i_cap=32), _cfg(tcfg, i_cap=32)
    jv = JVideo(jcf)
    jv.poses = jnp.asarray(s["poses"])
    jv.disps = jnp.asarray(s["disps"])
    jv.intrinsics = jnp.asarray(s["intr"])
    jv.counter = s["n_kf"]
    jgr = jg.CovisibleGraph(jv, None, jcf)
    tv = TVideo(tcf, torch.device("cpu"))
    tv.poses.copy_(torch.tensor(s["poses"]))
    tv.disps.copy_(torch.tensor(s["disps"]))
    tv.intrinsics = torch.tensor(s["intr"])
    tv.counter = s["n_kf"]
    tgr = tg.CovisibleGraph(tv, None, tcf)
    for gr in (jgr, tgr):
        gr.ii = np.asarray([3, 4], np.int64)
        gr.jj = np.asarray([4, 3], np.int64)
        gr.age = np.zeros(2, np.int64)
    for args in ((0, 0, 2, 2), (4, 4, 2, 1)):
        t0, t1, rad, nms = args
        for gr in (jgr, tgr):
            gr.add_proximity_factors(t0, t1, rad=rad, nms=nms, beta=0.3, thresh=20.0,
                                     remove=True)
        np.testing.assert_array_equal(tgr.ii, jgr.ii)
        np.testing.assert_array_equal(tgr.jj, jgr.jj)
    assert len(tgr.ii) > 2


def test_graphops_builds_the_native_source():
    """The port builds native/graphops.cpp itself (no copy to drift) into
    its own build directory."""
    import os

    from dbaf_tpu_torch.utils import cuda_build

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cuda_build.GRAPHOPS_SRC == os.path.join(root, "native", "graphops.cpp")
    assert not os.path.exists(os.path.join(root, "dbaf_tpu_torch", "csrc", "graphops.cpp"))
    lib = cuda_build.load_graphops()
    assert os.path.dirname(lib._name) == cuda_build.BUILD_DIR
