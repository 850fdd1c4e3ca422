"""The edge quarantine (``CovisibleGraph.filter_edges``, ``last_conf``, the
``ii_bad``/``jj_bad`` store) against the JAX package
(``dbaf_tpu/slam/graph.py:688-701,734-753,1202-1203,1230-1231``).

Confidences are planted on the same graph in both packages; ``filter_edges``
quarantines the long-range edges (|i - j| > 2) whose mean confidence is
under 1e-3; a rollup shifts the store and drops the edges it pushes below
frame 0; a proximity selection then takes the store among its suppression
seeds.  Every step must leave the same stores and select the same edges.
Also: the per-edge confidence an update leaves on the device against the
JAX package's, the asynchronous pipelines carrying a non-empty store across
a drain, and a save/load round trip of it.  As in the reference, no path
calls ``filter_edges``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbaf_tpu.slam import graph as jg
from dbaf_tpu.slam.video import DepthVideo as JVideo
from dbaf_tpu.utils import config as jcfg
from dbaf_tpu_torch.slam import graph as tg
from dbaf_tpu_torch.slam.video import DepthVideo as TVideo
from dbaf_tpu_torch.utils import config as tcfg
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_graph import _cfg, _state

# (ii, jj, planted confidence): long-range and low -> quarantined; long-range
# and high, or short-range and low -> kept.  Dyadic values, so that the mean
# of a row of them is exact in f32; (5, 1) sits just over the 1e-3 threshold
# and (8, 5) just under it
EDGES = [(0, 4, 2.0 ** -11), (4, 0, 0.875), (1, 2, 2.0 ** -17), (6, 2, 2.0 ** -12),
         (2, 6, 2.0 ** -9), (3, 4, 0.5), (7, 3, 0.0), (5, 1, 2.0 ** -10 + 2.0 ** -15),
         (8, 5, 2.0 ** -10), (4, 5, 0.75)]


def graphs():
    """The same 9-keyframe graph in both packages (JAX, port)."""
    s = _state(4, n_kf=9)
    jcf, tcf = _cfg(jcfg, i_cap=32), _cfg(tcfg, i_cap=32)
    jv = JVideo(jcf)
    jv.poses, jv.disps = jnp.asarray(s["poses"]), jnp.asarray(s["disps"])
    jv.intrinsics = jnp.asarray(s["intr"])
    jv.counter = s["n_kf"]
    tv = TVideo(tcf, torch.device("cpu"))
    tv.poses.copy_(torch.tensor(s["poses"]))
    tv.disps.copy_(torch.tensor(s["disps"]))
    tv.intrinsics = torch.tensor(s["intr"])
    tv.counter = s["n_kf"]
    out = (jg.CovisibleGraph(jv, None, jcf), tg.CovisibleGraph(tv, None, tcf))
    ii, jj, conf = (np.asarray(c) for c in zip(*EDGES))
    full = np.zeros(tcf.graph.edge_capacity, np.float32)
    full[:len(conf)] = conf
    for gr in out:
        gr.ii, gr.jj = ii.astype(np.int64), jj.astype(np.int64)
        gr.age = np.zeros(len(ii), np.int64)
        gr.ii_inac, gr.jj_inac = np.asarray([0, 1], np.int64), np.asarray([2, 3], np.int64)
    # the JAX graph keeps the update's confidence; the port reads it off the
    # edge weights, planted here as a constant per edge row
    out[0]._conf_dev = jnp.asarray(full)
    out[1].edges.weight[:] = torch.as_tensor(full)[:, None, None, None]
    return out


def assert_stores_equal(jgr, tgr):
    for name in ("ii", "jj", "age", "ii_bad", "jj_bad", "ii_inac", "jj_inac"):
        np.testing.assert_array_equal(getattr(tgr, name), getattr(jgr, name), err_msg=name)


def test_filter_roll_select_match_jax():
    jgr, tgr = graphs()
    np.testing.assert_array_equal(tgr.last_conf, np.asarray(jgr.last_conf))
    for gr in (jgr, tgr):
        gr.filter_edges()
    assert_stores_equal(jgr, tgr)
    # quarantined: the long-range edges under 1e-3 (2^-11, 2^-12, 0.0, 2^-10)
    assert sorted(zip(tgr.ii_bad.tolist(), tgr.jj_bad.tolist())) == [(0, 4), (6, 2), (7, 3),
                                                                     (8, 5)]
    assert tgr.n == len(EDGES) - 4
    for gr in (jgr, tgr):
        gr.shift_indices(1)
    assert_stores_equal(jgr, tgr)
    assert (0 - 1, 4 - 1) not in zip(tgr.ii_bad, tgr.jj_bad) and len(tgr.ii_bad) == 3
    # the video rolled too: one keyframe fewer, as the frontend counts; the
    # selection's suppression seeds are the active, quarantined and inactive
    # edges, in that order
    seeds = []
    select = tg.select_proximity_edges

    def recording(d, ii, jj, cc, exist_ii, exist_jj, *rest):
        seeds.append((exist_ii.copy(), exist_jj.copy()))
        return select(d, ii, jj, cc, exist_ii, exist_jj, *rest)

    n_act = tgr.n
    tg.select_proximity_edges = recording
    try:
        for gr in (jgr, tgr):
            gr.video.counter -= 1
            gr.add_proximity_factors(0, 0, rad=2, nms=1, beta=0.3, thresh=20.0, remove=True)
    finally:
        tg.select_proximity_edges = select
    assert_stores_equal(jgr, tgr)
    (ei, ej), = seeds
    nb = len(tgr.ii_bad)
    np.testing.assert_array_equal(ei[n_act:n_act + nb], tgr.ii_bad)
    np.testing.assert_array_equal(ej[n_act:n_act + nb], tgr.jj_bad)


@pytest.mark.parametrize("native", [True, False])
def test_selection_seeds_with_the_store_match_jax(native, monkeypatch):
    """Both routes of the proximity selection (the native scheduler and the
    Python stand-in) take active, quarantined and inactive edges as seeds."""
    from dbaf_tpu.utils import native as jnative

    if not native:
        monkeypatch.setattr(jnative, "select_proximity_edges", lambda *a, **k: None)
        monkeypatch.setattr(tg, "select_proximity_edges", lambda *a, **k: None)
    jgr, tgr = graphs()
    for gr in (jgr, tgr):
        gr.filter_edges()
        gr.add_proximity_factors(4, 4, rad=2, nms=2, beta=0.3, thresh=20.0, remove=True)
    assert_stores_equal(jgr, tgr)


def test_update_leaves_the_edge_confidence_of_jax():
    """``last_conf`` after the same straight-fed run in both packages: the
    mean confidence of each edge row the last update left, read off the
    weights on the device."""
    from tests.test_slam_e2e import Harness, make_cfg, make_scene
    from tests.test_torch_stereo import INTR, PortHarness, jax_feed, port_cfg

    cfg = make_cfg()
    gt_poses, gt_disps = make_scene(12, INTR)
    hj = Harness(cfg, gt_poses, gt_disps, INTR)
    ht = PortHarness(port_cfg(cfg), gt_poses, gt_disps)
    for k in range(12):
        jax_feed(hj, k)
        ht.feed(k)
    n = ht.graph.n
    assert n == hj.graph.n and n > 0
    conf_t = ht.graph.last_conf
    np.testing.assert_allclose(conf_t[:n], np.asarray(hj.graph.last_conf)[:n], atol=1e-6)
    assert conf_t[:n].min() > 0.0
    np.testing.assert_allclose(conf_t, ht.graph.edges.weight.mean(dim=(1, 2, 3)).numpy())


def test_pipelines_carry_the_store_across_a_drain():
    """A non-empty store enters the visual pipeline at activation and comes
    back at the drain (one read with the rest of the edge state)."""
    from dbaf_tpu_torch.slam.system import DBAFusion
    from tests.test_async_pipeline import make_scene
    from tests.test_torch_async_pipeline import INTR, INTR_FULL, frames, port_cfg, port_fns

    gt_poses, gt_disps = make_scene(12, INTR)
    cfg = port_cfg(True)
    sysm = DBAFusion(cfg, device="cpu", **dict(zip(("feat_fn", "ctx_fn", "update_fn"),
                                                   port_fns(gt_poses, gt_disps, cfg.buffer))))
    imgs = frames(12)
    for k in range(9):
        sysm.track(float(k), imgs[k], intrinsics=INTR_FULL)
    a = sysm._async
    assert a.active
    a.sync()
    g = sysm.graph
    g.ii_bad, g.jj_bad = np.asarray([0, 1], np.int64), np.asarray([6, 7], np.int64)
    a.activate()
    assert a.state["bad_valid"].tolist()[:3] == [True, True, False]
    for k in range(9, 12):
        sysm.track(float(k), imgs[k], intrinsics=INTR_FULL)
    a.sync()
    np.testing.assert_array_equal(g.ii_bad, [0, 1])
    np.testing.assert_array_equal(g.jj_bad, [6, 7])


def test_save_load_round_trip_keeps_the_store(tmp_path):
    from dbaf_tpu.slam.system import DBAFusion as JSystem
    from tests.test_slam_e2e import make_cfg, make_scene
    from tests.test_torch_save_state import _facade, _load_file
    from tests.test_torch_stereo import INTR, PortHarness, port_cfg

    cfg = port_cfg(make_cfg())
    gt_poses, gt_disps = make_scene(12, INTR)
    h = PortHarness(cfg, gt_poses, gt_disps)
    for k in range(10):
        h.feed(k)
    h.graph.ii_bad = np.asarray([1, 2, 0], np.int64)
    h.graph.jj_bad = np.asarray([5, 7, 6], np.int64)
    path = str(tmp_path / "state.pkl")
    _facade(h.video, h.graph, h.frontend).save_state(path)
    state = _load_file(path)
    assert set(state["graph"]) == set(JSystem._GRAPH_HOST)  # the JAX file's graph keys
    h2 = PortHarness(cfg, gt_poses, gt_disps)
    _facade(h2.video, h2.graph, h2.frontend).load_state(path)
    np.testing.assert_array_equal(h2.graph.ii_bad, [1, 2, 0])
    np.testing.assert_array_equal(h2.graph.jj_bad, [5, 7, 6])
