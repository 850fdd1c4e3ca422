"""The port's device edge scheduler (``dbaf_tpu_torch/slam/edge_select.py``)
held to BIT equality against the native host scheduler
(``native/graphops.cpp`` through the port's ctypes loader) and against the
JAX replica (``dbaf_tpu/slam/edge_select.py``), on the fuzz cases of
``tests/test_edge_select.py`` (8 selection seeds, 4 transition seeds each).

The host replays the same selection from the lagged drain pack, so any
divergence would desynchronise its mirrors: the sequences must match
exactly, order included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_edge_select import make_case

THRESH, MAX_FACTORS, MAX_OUT = 16.0, 48, 160
T = lambda a: torch.as_tensor(np.asarray(a, np.int64))  # noqa: E731


def _port_select(case, nv):
    from dbaf_tpu_torch.slam.edge_select import select_proximity_edges

    mask = torch.arange(len(case["exist_ii"])) < nv
    out_ii, out_jj, m = select_proximity_edges(
        torch.as_tensor(case["d"], dtype=torch.float32), T(case["ii"]), T(case["jj"]),
        T(case["exist_ii"]), T(case["exist_jj"]), mask, T(case["t0"]), T(case["t1"]),
        T(case["t"]), THRESH, src=5, win=5, n_skip=3, rad=case["rad"], nms=case["nms"],
        max_factors=MAX_FACTORS, max_out=MAX_OUT)
    return out_ii[m].numpy(), out_jj[m].numpy()


@pytest.mark.parametrize("seed", range(8))
def test_select_matches_native_and_jax(seed):
    from dbaf_tpu.slam.edge_select import select_proximity_edges as jax_select
    from dbaf_tpu_torch.slam.graph import select_proximity_edges as native_select

    rng = np.random.default_rng(seed)
    case = make_case(rng, nms=int(rng.integers(0, 3)))
    nv = case["n_valid"]
    ref_ii, ref_jj = native_select(
        case["d"].copy(), case["ii"], case["jj"], case["cc"], case["exist_ii"][:nv],
        case["exist_jj"][:nv], case["t0"], case["t1"], case["t"], case["rad"], case["nms"],
        THRESH, MAX_FACTORS)
    got_ii, got_jj = _port_select(case, nv)
    np.testing.assert_array_equal(got_ii, ref_ii)
    np.testing.assert_array_equal(got_jj, ref_jj)

    j_ii, j_jj, j_m = jax_select(
        jnp.asarray(case["d"], jnp.float32), jnp.asarray(case["ii"], jnp.int32),
        jnp.asarray(case["jj"], jnp.int32), jnp.asarray(case["exist_ii"], jnp.int32),
        jnp.asarray(case["exist_jj"], jnp.int32), jnp.asarray(np.arange(24) < nv),
        jnp.asarray(case["t0"], jnp.int32), jnp.asarray(case["t1"], jnp.int32),
        jnp.asarray(case["t"], jnp.int32), THRESH, src=5, win=5, n_skip=3, rad=case["rad"],
        nms=case["nms"], max_factors=MAX_FACTORS, max_out=MAX_OUT)
    j_m = np.asarray(j_m)
    np.testing.assert_array_equal(got_ii, np.asarray(j_ii)[j_m])
    np.testing.assert_array_equal(got_jj, np.asarray(j_jj)[j_m])


# ---------------------------------------------------------------------------
# transitions against the port's host graph machinery and the JAX replica

WF, SRC, RAD, NMS = 5, 5, 2, 1
SKIP = (-4, -5, -6)


def _cfg():
    from dbaf_tpu_torch.utils.config import DBAFusionConfig, GraphConfig

    return DBAFusionConfig(
        image_size=(64, 128), buffer=24,
        graph=GraphConfig(max_factors=12, edge_capacity=16, inactive_capacity=12,
                          frontend_window=WF, frontend_radius=RAD, frontend_nms=NMS,
                          frontend_thresh=16.0, max_age=8, skip_edge=SKIP))


def _graph(rng, t, n_edges, n_inac, n_aged):
    """A port CovisibleGraph with random poses, disparities, features and
    edges, some retired and some aged past max_age (test_edge_select.py)."""
    from dbaf_tpu_torch.slam.graph import CovisibleGraph
    from dbaf_tpu_torch.slam.video import DepthVideo

    cfg = _cfg()
    video = DepthVideo(cfg, "cpu")
    video.counter = t
    B, h8, w8 = cfg.buffer, video.h8, video.w8
    poses = np.concatenate([rng.normal(size=(B, 3)) * 0.05, np.tile([0, 0, 0, 1.0], (B, 1))], 1)
    video.poses.copy_(torch.as_tensor(poses, dtype=torch.float32))
    video.disps.copy_(torch.as_tensor(rng.uniform(0.5, 2.0, (B, h8, w8)), dtype=torch.float32))
    video.nets.copy_(torch.as_tensor(rng.normal(size=(B, h8, w8, 128))).to(torch.bfloat16))
    video.intrinsics = torch.tensor([2.0 * w8, 2.0 * w8, w8 / 2, h8 / 2])
    g = CovisibleGraph(video, lambda *a: None, cfg)
    pairs = set()
    while len(pairs) < n_edges + n_inac:
        a, b = rng.integers(0, t, size=2)
        if a != b:
            pairs.add((int(a), int(b)))
    pairs = sorted(pairs)
    g.add_factors([p[0] for p in pairs], [p[1] for p in pairs])
    g.flush()
    g.edges.target.copy_(torch.as_tensor(rng.normal(size=g.edges.target.shape), dtype=torch.float32))
    g.edges.weight.copy_(torch.as_tensor(rng.uniform(size=g.edges.weight.shape), dtype=torch.float32))
    g.age = rng.integers(0, 10, size=g.n).astype(np.int64)
    if n_inac:
        m = np.zeros(g.n, dtype=bool)
        m[rng.choice(g.n, size=n_inac, replace=False)] = True
        g.rm_factors(m, store=True)
        g.flush()
    if n_aged and g.n:
        g.age[rng.choice(g.n, size=min(n_aged, g.n), replace=False)] = cfg.graph.max_age + 5
    return video, g


def _snapshot(g):
    E, I = g.e_cap, g.i_cap
    pad = lambda a, n: np.concatenate([a, np.zeros(n - len(a), np.int64)])  # noqa: E731
    return dict(
        ii=pad(g.ii, E), jj=pad(g.jj, E), age=pad(g.age, E), valid=np.arange(E) < g.n,
        ii_i=pad(g.ii_inac, I), jj_i=pad(g.jj_inac, I), i_valid=np.arange(I) < len(g.ii_inac),
        net=g.edges.net.clone(), target=g.edges.target.clone(), weight=g.edges.weight.clone(),
        t_inac=g.t_inac.clone(), w_inac=g.w_inac.clone())


def _assert_index_state(out, g, jax_out=None):
    n = int(out["valid"].sum())
    assert n == g.n
    for k, ref in (("ii", g.ii), ("jj", g.jj), ("age", g.age)):
        np.testing.assert_array_equal(out[k][:n].numpy(), ref, err_msg=k)
    ni = int(out["i_valid"].sum())
    assert ni == len(g.ii_inac)
    np.testing.assert_array_equal(out["ii_i"][:ni].numpy(), g.ii_inac)
    np.testing.assert_array_equal(out["jj_i"][:ni].numpy(), g.jj_inac)
    if jax_out is not None:  # every output, padding included, as the replica's
        for k, v in out.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jax_out[k]), err_msg=k)
    return n, ni


def _jax(a, dt=jnp.int32):
    return jnp.asarray(np.asarray(a), dt)


@pytest.mark.parametrize("seed", range(4))
def test_edge_transition_matches_host_and_jax(seed):
    from dbaf_tpu.slam.edge_select import edge_transition as jax_transition
    from dbaf_tpu_torch.slam.edge_select import edge_transition
    from dbaf_tpu_torch.slam.graph import EdgeArrays, _rebuild_edges, _rebuild_inactive

    rng = np.random.default_rng(100 + seed)
    t1, aw = 14, 10
    video, g = _graph(rng, t1, n_edges=10, n_inac=3, n_aged=3)
    n_skip = len(SKIP)
    d_syn = rng.uniform(0, 30, size=SRC * WF + n_skip)
    d_syn[rng.random(len(d_syn)) < 0.15] = 150.0
    pre = _snapshot(g)
    mc = g.cfg.graph

    # host path (the frontend's visual stale rule + proximity selection)
    stale = (g.age > mc.max_age) & ((g.ii < t1 - aw) | (g.jj < t1 - aw))
    g.rm_factors(stale, store=True)
    g._candidate_distances = lambda *a, **k: d_syn.copy()
    g.add_proximity_factors(t1 - SRC, max(t1 - WF, 0), rad=RAD, nms=NMS,
                            thresh=mc.frontend_thresh, remove=True)
    g.flush()

    kw = dict(src=SRC, wf=WF, n_skip=n_skip, skip_offsets=SKIP, rad=RAD, nms=NMS,
              max_factors=mc.max_factors, max_age=mc.max_age, active_window=aw,
              visual_only=True, max_out=MAX_OUT)
    z4 = np.zeros(4, np.int64)
    out = edge_transition(
        T(pre["ii"]), T(pre["jj"]), T(pre["age"]), torch.as_tensor(pre["valid"]),
        T(pre["ii_i"]), T(pre["jj_i"]), torch.as_tensor(pre["i_valid"]), T(z4), T(z4),
        torch.zeros(4, dtype=torch.bool), torch.as_tensor(d_syn, dtype=torch.float32),
        T(t1), mc.frontend_thresh, **kw)
    jout = jax_transition(
        _jax(pre["ii"]), _jax(pre["jj"]), _jax(pre["age"]), _jax(pre["valid"], bool),
        _jax(pre["ii_i"]), _jax(pre["jj_i"]), _jax(pre["i_valid"], bool), _jax(z4), _jax(z4),
        jnp.zeros(4, bool), jnp.asarray(d_syn, jnp.float32), jnp.asarray(t1, jnp.int32),
        mc.frontend_thresh, **kw)
    n, ni = _assert_index_state(out, g, jout)

    # the rebuilt stores equal the host flush
    edges = EdgeArrays(g.e_cap, video.h8, video.w8, "cpu")
    edges.assign((pre["net"], pre["target"], pre["weight"]))
    net, target, _ = _rebuild_edges(edges, out["perm"], out["is_new"], out["ii"], out["jj"],
                                    video.poses, video.disps, video.intrinsics,
                                    video.nets[out["ii"]])
    np.testing.assert_array_equal(net[:n].float().numpy(), g.edges.net[:n].float().numpy())
    np.testing.assert_allclose(target[:n].numpy(), g.edges.target[:n].numpy(), atol=1e-5)
    t2, w2 = _rebuild_inactive(pre["t_inac"], pre["w_inac"], out["inact_perm_old"],
                               out["inact_from_act"], out["inact_act_idx"], pre["target"],
                               pre["weight"])
    np.testing.assert_array_equal(t2[:ni].numpy(), g.t_inac[:ni].numpy())
    np.testing.assert_array_equal(w2[:ni].numpy(), g.w_inac[:ni].numpy())


@pytest.mark.parametrize("seed", range(4))
def test_cull_transition_matches_host_and_jax(seed):
    from dbaf_tpu.slam.edge_select import cull_transition as jax_cull
    from dbaf_tpu_torch.slam.edge_select import cull_transition
    from dbaf_tpu_torch.slam.graph import EdgeArrays, _rebuild_edges, _rebuild_inactive

    rng = np.random.default_rng(300 + seed)
    t1 = 14
    video, g = _graph(rng, t1, n_edges=10, n_inac=3, n_aged=0)
    ix = int(rng.integers(1, t1 - 1))
    pre = _snapshot(g)
    g.rm_keyframe(ix)
    g.flush()

    args = (pre["ii"], pre["jj"], pre["age"], pre["valid"], pre["ii_i"], pre["jj_i"],
            pre["i_valid"])
    out = cull_transition(*(torch.as_tensor(a) for a in args), T(ix))
    jout = jax_cull(*(_jax(a, bool if a.dtype == bool else jnp.int32) for a in args),
                    jnp.asarray(ix, jnp.int32))
    n, ni = _assert_index_state(out, g, jout)

    edges = EdgeArrays(g.e_cap, video.h8, video.w8, "cpu")
    edges.assign((pre["net"], pre["target"], pre["weight"]))
    E, I = g.e_cap, g.i_cap
    rebuilt = _rebuild_edges(edges, out["perm"], torch.zeros(E, dtype=torch.bool), out["ii"],
                             out["jj"], video.poses, video.disps, video.intrinsics,
                             video.nets[out["ii"]])
    for got, ref in zip(rebuilt, (g.edges.net, g.edges.target, g.edges.weight)):
        np.testing.assert_array_equal(got[:n].float().numpy(), ref[:n].float().numpy())
    t2, w2 = _rebuild_inactive(pre["t_inac"], pre["w_inac"], out["inact_perm_old"],
                               torch.zeros(I, dtype=torch.bool), torch.zeros(I, dtype=torch.int64),
                               pre["target"], pre["weight"])
    np.testing.assert_array_equal(t2[:ni].numpy(), g.t_inac[:ni].numpy())
    np.testing.assert_array_equal(w2[:ni].numpy(), g.w_inac[:ni].numpy())


@pytest.mark.parametrize("seed", range(4))
def test_roll_transition_matches_host_and_jax(seed):
    """roll_transition against graph.shift_indices: inactive entries whose
    indices go negative drop, the rest compact in order and shift down;
    bad edges likewise."""
    from dbaf_tpu.slam.edge_select import roll_transition as jax_roll
    from dbaf_tpu_torch.slam.edge_select import roll_transition
    from dbaf_tpu_torch.slam.graph import _rebuild_inactive

    rng = np.random.default_rng(500 + seed)
    t1 = 20
    video, g = _graph(rng, t1, n_edges=6, n_inac=6, n_aged=0)
    r = int(rng.integers(2, 8))
    pre = _snapshot(g)
    bad_ii = rng.integers(0, t1, size=8)
    bad_jj = rng.integers(0, t1, size=8)
    bad_valid = np.arange(8) < int(rng.integers(0, 8))
    g.ii, g.jj = g.ii + r, g.jj + r  # keep the active edges nonnegative after the shift
    g.shift_indices(r)

    args = (pre["ii_i"], pre["jj_i"], pre["i_valid"], bad_ii, bad_jj, bad_valid)
    out = roll_transition(*(torch.as_tensor(a) for a in args), r)
    jout = jax_roll(*(_jax(a, bool if a.dtype == bool else jnp.int32) for a in args), r)
    for k, v in out.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jout[k]), err_msg=k)
    ni = int(out["i_valid"].sum())
    assert ni == len(g.ii_inac)
    np.testing.assert_array_equal(out["ii_i"][:ni].numpy(), g.ii_inac)
    np.testing.assert_array_equal(out["jj_i"][:ni].numpy(), g.jj_inac)
    keep_b = bad_valid & (bad_ii >= r) & (bad_jj >= r)
    nb = int(out["bad_valid"].sum())
    np.testing.assert_array_equal(out["bad_ii"][:nb].numpy(), bad_ii[keep_b] - r)
    np.testing.assert_array_equal(out["bad_jj"][:nb].numpy(), bad_jj[keep_b] - r)
    I = g.i_cap
    t2, _ = _rebuild_inactive(pre["t_inac"], pre["w_inac"], out["inact_perm_old"],
                              torch.zeros(I, dtype=torch.bool), torch.zeros(I, dtype=torch.int64),
                              pre["target"], pre["weight"])
    np.testing.assert_array_equal(t2[:ni].numpy(), g.t_inac[:ni].numpy())
