"""The handoff between the synchronous flow and the device pipelines, seam
by seam, on the CPU:

* ``CovisibleGraph.carry`` -> ``read_ints`` -> ``CovisibleGraph.restore``
  gives back every edge store (the quarantine cut to ``BAD_CAP``, as the
  steps carry it) and drops the pending membership change;
* ``MultiSensorBA.carry`` -> ``restore_carry`` gives back the window state,
  its origin, the device marginal and the edge selection, with and without a
  cull the device decided and never applied;
* the coupled step's pack (``coupled_fused.build_pack``) parses back into
  its fields (``pack_fields``) on the device tensor and on its host copy, as
  the synchronous fused step writes it (an int window origin) and as the
  asynchronous step does (a 0-d device origin), at ``fg_cap`` 20.

Every field is filled with values no other field holds, so a field dropped
or shifted fails its comparison.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dbaf_tpu_torch.fusion import device_graph as dg
from dbaf_tpu_torch.slam.coupled import MultiSensorBA
from dbaf_tpu_torch.slam.coupled_fused import build_pack, pack_fields
from dbaf_tpu_torch.slam.graph import (BAD_CAP, EDGE_CARRY, CovisibleGraph, StepPack, n_prox,
                                       prox_fields, read_ints)
from dbaf_tpu_torch.slam.video import DepthVideo
from dbaf_tpu_torch.utils import config as tcfg
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
NW = 20


def _cfg():
    return tcfg.DBAFusionConfig(
        image_size=(48, 64), buffer=32,
        graph=tcfg.GraphConfig(max_factors=16, edge_capacity=24, inactive_capacity=12,
                               skip_edge=(-4, -5, -6)),
        ba=tcfg.BAConfig(window=NW + 2), sensors=tcfg.SensorConfig(fg_cap=NW))


def _graph(cfg):
    return CovisibleGraph(DepthVideo(cfg, CPU), None, cfg)


def _filled_graph(cfg, n_bad):
    """A graph whose stores hold distinct values: active 10, inactive 7,
    quarantined ``n_bad``."""
    g = _graph(cfg)
    g.ii, g.jj = np.arange(100, 110), np.arange(200, 210)
    g.age = np.arange(300, 310)
    g.ii_inac, g.jj_inac = np.arange(400, 407), np.arange(500, 507)
    g.ii_bad, g.jj_bad = np.arange(600, 600 + n_bad), np.arange(800, 800 + n_bad)
    return g


EDGE_STORES = ("ii", "jj", "age", "ii_inac", "jj_inac", "ii_bad", "jj_bad")


@pytest.mark.parametrize("n_bad", [3, BAD_CAP + 6])
def test_graph_carry_restore_round_trip(n_bad):
    cfg = _cfg()
    g = _filled_graph(cfg, n_bad)
    t1 = 30
    dists = torch.arange(n_prox(cfg), dtype=torch.float32) + 0.5
    g.set_prox(t1, StepPack(dists, prox_fields))
    st = g.carry(t1)
    assert set(st) == {*EDGE_CARRY, "prox_d"}
    # the distances are the held ones, copied
    assert torch.equal(st["prox_d"], dists) and st["prox_d"].data_ptr() != dists.data_ptr()
    E, I = cfg.graph.edge_capacity, cfg.graph.inactive_capacity
    for k, cap in (("ii", E), ("jj", E), ("age", E), ("e_valid", E), ("ii_i", I), ("jj_i", I),
                   ("i_valid", I), ("bad_ii", BAD_CAP), ("bad_jj", BAD_CAP),
                   ("bad_valid", BAD_CAP)):
        assert st[k].shape == (cap,), k

    back = _graph(cfg)
    back.add_factors([1, 2], [3, 4])  # a pending change the drain must drop
    back.restore(read_ints(st, EDGE_CARRY))
    for name in EDGE_STORES:
        want = getattr(g, name)
        if name.endswith("_bad"):  # the steps carry the first BAD_CAP
            want = want[:BAD_CAP]
        np.testing.assert_array_equal(getattr(back, name), want, err_msg=name)
    assert not back._dirty and not back._is_new.any()
    np.testing.assert_array_equal(back._perm, np.arange(cfg.graph.edge_capacity))


def test_graph_carry_computes_distances_for_another_count():
    """Distances held for another keyframe count are not reused."""
    cfg = _cfg()
    g = _filled_graph(cfg, 0)
    g.set_prox(29, StepPack(torch.zeros(n_prox(cfg)), prox_fields))
    prox = g.carry(30)["prox_d"]
    np.testing.assert_array_equal(
        prox.numpy(), g.update_step.host_metrics(g.video, 30)[1:].numpy())


def _window(cfg, t0=5, t1=17, n_sel=9, cap=36):
    """A MultiSensorBA with a device window [t0, t1), a device marginal at
    t0 and an edge selection, each of distinct values."""
    c = MultiSensorBA(DepthVideo(cfg, CPU), cfg)
    c.last_t0, c.last_t1 = t0, t1
    c._fg_state = torch.arange(NW * 21, dtype=torch.float32) * 0.25
    c._fg_key = (t0, t1)
    N = 15 * NW
    c._marg_dev = dg.MargDense(torch.arange(NW) % 3 == 0,
                               torch.arange(NW * 21, dtype=torch.float32).reshape(NW, 21) + 1e3,
                               torch.arange(N * N, dtype=torch.float32).reshape(N, N) + 2e5,
                               torch.arange(N, dtype=torch.float32) + 7e5)
    c._marg_dev_origin = t0
    c.cur_ii, c.cur_jj = np.arange(t0, t0 + n_sel), np.arange(t0 + 40, t0 + 40 + n_sel)
    c.cur_target = torch.full((cap, 2, 2, 2), 3.0)
    c.cur_weight = torch.full((cap, 2, 2, 2), 4.0)
    return c


@pytest.mark.parametrize("culled", [False, True])
def test_window_carry_restore_round_trip(culled):
    cfg = _cfg()
    t0, t1, cap = 5, 17, 36
    c = _window(cfg, t0, t1, cap=cap)
    st = c.carry(cap)
    assert set(st) == {"fg_flat", "o_prev", "mgd_mask", "mgd_lin", "mgd_H", "mgd_v", "cur_ii",
                       "cur_jj", "cur_mask", "cur_target", "cur_weight"}
    # the carried state is a copy: the steps write it, the host keeps its own
    assert torch.equal(st["fg_flat"], c._fg_state)
    assert st["fg_flat"].data_ptr() != c._fg_state.data_ptr()
    assert st["o_prev"].shape == () and int(st["o_prev"]) == t0
    assert st["cur_ii"].shape == (cap,) and int(st["cur_mask"].sum()) == len(c.cur_ii)

    back = MultiSensorBA(DepthVideo(cfg, CPU), cfg)
    h = read_ints(st, back.CARRY_INTS)
    back.restore_carry(st, h, t1, culled=t1 - 2 if culled else None)
    assert (back.last_t0, back.last_t1) == (t0, t1)
    np.testing.assert_array_equal(back.cur_ii, c.cur_ii)
    np.testing.assert_array_equal(back.cur_jj, c.cur_jj)
    assert back.cur_target is st["cur_target"] and back.cur_weight is st["cur_weight"]
    mgd = back.marginal_on_device(t0, t1, NW)
    for got, want in zip(mgd, c._marg_dev):
        assert torch.equal(got, want)
    rows = c._fg_state.reshape(NW, 21).double().numpy()
    if culled:
        # the culled keyframe's row leaves the window; the rows above move down
        r = t1 - 2 - t0
        want = np.concatenate([rows[:r], rows[r + 1:], rows[-1:]])
        assert back._fg_key == (t0, t1 - 1)
        np.testing.assert_array_equal(back._fg_rows_np.reshape(NW, 21), want)
        np.testing.assert_array_equal(back._fg_state.reshape(NW, 21).double().numpy(), want)
    else:
        assert back._fg_key == (t0, t1) and back._fg_rows_np is None
        assert back._fg_state is st["fg_flat"]
        assert back.has_device_window()


def _pack_parts(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.rand(*s, generator=g) + 1.0  # noqa: E731
    return dict(cull=torch.tensor(True), d=r(()) + 10.0, prox=r(n_prox(cfg)) + 20.0,
                hyst=r(7) + 30.0, fg_flat=r(NW * 21) + 40.0, pose=r(12) + 50.0)


@pytest.mark.parametrize("flow", ["sync", "async"])
def test_pack_fields_read_what_build_pack_wrote(flow):
    """The synchronous fused step hands ``build_pack`` its window origin as
    an int, the asynchronous step as a 0-d device tensor; either pack
    parses into the same fields, on the device and on the host."""
    cfg = _cfg()
    parts = _pack_parts(cfg, 3)
    t0 = 11 if flow == "sync" else torch.tensor(11, dtype=torch.int64)
    pack = build_pack(parts["cull"], parts["d"], parts["prox"], parts["hyst"],
                      parts["fg_flat"], parts["pose"], t0)
    assert pack.shape == (2 + n_prox(cfg) + 7 + NW * 21 + 12 + 1,)
    for f in (pack_fields(pack, cfg), pack_fields(pack.numpy(), cfg)):
        T = lambda x: torch.as_tensor(np.asarray(x))  # noqa: E731
        assert float(f.cull) == 1.0 and float(f.d) == float(parts["d"])
        assert torch.equal(T(f.prox), parts["prox"])
        assert torch.equal(T(f.hyst), parts["hyst"])
        assert tuple(f.rows.shape) == (NW, 21)
        assert torch.equal(T(f.rows).reshape(-1), parts["fg_flat"])
        assert torch.equal(T(f.pose), parts["pose"])
        assert float(f.t0) == 11.0
    # the device fields are views of the pack: cutting it launches nothing
    dev = pack_fields(pack, cfg)
    assert dev.rows.data_ptr() == pack.data_ptr() + 4 * (2 + n_prox(cfg) + 7)
