"""The port's device factor graph with GNSS rows, against the JAX package's
and the host f64 graph (``fusion/graph.py``), on
``test_torch_device_graph.py``'s window (IMU chain, pose and bias priors,
odometry, a genuine marginal, a visual hessian) with georeferenced GNSS
fixes on four of its frames.

The fixes are the frames' positions plus a lever arm, in ECEF about a
``ten0``, with offsets of 1-2 cm on two frames (``e2`` under the Cauchy
``k2`` of 0.0064) and of 0.8-1.5 m on the other two (``e2`` over 50 times
``k2``: the robust weight's tail).  The tolerances are the other file's:
port against JAX 1e-5 of the scale for the normal equations and 1e-4 for
LM and the marginal, port against the host f64 graph 2e-4 of the scale,
5e-3 for the LM optimum and 5e-4 of the scale for the marginal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbaf_tpu.fusion import device_graph as jdg
from dbaf_tpu_torch.fusion import device_graph as tdg
from tests.test_device_graph import perm_to_device
from tests.test_torch_device_graph import (JAXP, NW, PORT, _jax_inputs, _perturb, _port_inputs,
                                           _visual_window, build_window, host_graph, host_values,
                                           make_vis)
from tests.test_torch_device_graph import one_torch_thread  # noqa: F401  (autouse)

TEN0 = np.array([-2694045.0, -4293642.0, 3857878.0])
TBG = np.array([0.12, -0.05, 0.3])
# per frame: None (no fix) or the fix's offset from the lever-armed position (m)
OFFSETS = {0: [0.01, -0.005, 0.002], 1: [-0.012, 0.008, 0.015], 2: None,
           3: [1.2, -0.7, 0.4], 4: [-0.5, 0.6, 1.1], 5: None}


def add_gnss(p, msba, n):
    """Georeference the window: GNSS fixes of OFFSETS' frames in ECEF."""
    from dbaf_tpu_torch.utils import geodesy

    msba.gnss_init_t1 = 1
    msba.ten0 = TEN0.copy()
    msba.tbg = TBG.copy()
    Cen = geodesy.Cen(TEN0)
    st = msba.state
    for i in range(n):
        off = OFFSETS.get(i)
        st.gnss_valid[i] = off is not None
        if off is not None:
            w = st.wTbs[i].t + st.wTbs[i].R @ TBG + np.asarray(off)
            st.gnss_position[i] = TEN0 + Cen @ w


def gps_factors(p, msba, n):
    """The host GPSFactors of the window, positions as pack_graph computes
    them (coupled.py's lever arm at the current attitude)."""
    from dbaf_tpu_torch.utils import geodesy

    out = []
    for i in range(n):
        if msba.state.gnss_valid[i]:
            pos = geodesy.Cen(msba.ten0).T @ (msba.state.gnss_position[i] - msba.ten0)
            out.append(p.GPSFactor(p.X(i), pos - msba.state.wTbs[i].R @ msba.tbg, p.GNSS_NOISE))
    return out


def both(n=5, seed=7, perturb_from=0):
    """``test_torch_device_graph._both`` with GNSS rows: (msba, vis arrays,
    host graph, host values) per package, the port's first."""
    out = []
    for p in (PORT, JAXP):
        msba, rng = build_window(p, seed, n)
        add_gnss(p, msba, n)
        lcf, vis = make_vis(p, rng, msba, n)
        _perturb(p, msba, rng, n, perturb_from)
        g = host_graph(p, msba, n, lcf)
        for f in gps_factors(p, msba, n):
            g.add(f)
        out.append((msba, vis, g, host_values(p, msba, n)))
    return out


def test_gnss_rows_reach_both_robust_regimes():
    """The scenario is what the docstring says: two fixes near the state,
    two in the Cauchy tail."""
    (tm, _, _, _), _ = both()
    pg = tdg.pack_graph(tm, 0, 5, NW)
    st = tdg.pack_state(tm, 0, 5, NW)
    r = (st.t - pg.gnss_pos).double()
    e2 = torch.einsum("ni,ij,nj->n", r, pg.gnss_info.double(), r)[pg.gnss_mask]
    k2 = float(pg.gnss_k2)
    assert int(pg.gnss_mask.sum()) == 4
    assert (e2 < k2).sum() == 2 and (e2 > 50 * k2).sum() == 2, (e2 / k2).tolist()


def test_pack_graph_gnss_rows_match_jax():
    """pack_graph's GNSS rows (port device_graph.py pack_graph_np, JAX
    :906-914) and their noise, and the whole flat pack, equal."""
    n = 5
    (tm, _, _, _), (jm, _, _, _) = both(n)
    tp, jp = tdg.pack_graph_np(tm, 0, n, NW), jdg.pack_graph_np(jm, 0, n, NW)
    for k in ("gnss_mask", "gnss_pos", "gnss_info", "gnss_k2"):
        np.testing.assert_array_equal(np.asarray(tp[k]), np.asarray(jp[k]), err_msg=k)
    assert np.asarray(tp["gnss_mask"]).tolist()[:n] == [OFFSETS[i] is not None for i in range(n)]
    np.testing.assert_array_equal(tdg.pack_graph_flat(tm, 0, n, NW),
                                  jdg.pack_graph_flat(jm, 0, n, NW))
    # not georeferenced: no row packs, as in JAX
    tm.gnss_init_t1 = jm.gnss_init_t1 = -1
    assert not np.asarray(tdg.pack_graph_np(tm, 0, n, NW)["gnss_mask"]).any()
    assert not np.asarray(jdg.pack_graph_np(jm, 0, n, NW)["gnss_mask"]).any()


def test_linearize_with_gnss_matches_jax_and_host():
    n = 5
    (tm, tvis, tg, tvals), (jm, jvis, _, _) = both(n)
    Ht, bt, et = tdg.linearize(*_port_inputs(tm, tvis, n))
    Hj, bj, ej = jdg.linearize(*_jax_inputs(jm, jvis, n))
    Ht, bt, et = Ht.numpy(), bt.numpy(), float(et)
    Hj, bj, ej = np.asarray(Hj), np.asarray(bj), float(ej)
    scale, bscale = np.abs(Hj).max(), max(np.abs(bj).max(), 1.0)
    np.testing.assert_allclose(Ht, Hj, atol=1e-5 * scale)
    np.testing.assert_allclose(bt, bj, atol=1e-5 * bscale)
    assert abs(et - ej) < 1e-5 * max(abs(ej), 1.0)

    keys, slices, Hh, bh, errh = tg.linearize(tvals)
    perm = perm_to_device(keys, slices, n, NW)
    live = perm >= 0
    sub = np.ix_(live, live)
    assert np.abs(Ht[sub] - Hh[np.ix_(perm[live], perm[live])]).max() < 2e-4 * scale
    assert np.abs(bt[live] - bh[perm[live]]).max() < 2e-4 * max(np.abs(bh).max(), 1.0)
    assert abs(et - errh) < 2e-4 * max(abs(errh), 1.0)


def _gnss_only(args, zeros, false):
    """Linearize inputs with every term but the GNSS rows masked off (the
    IMU chain's information is ~1e9, and hides the robust term's f32
    contribution in the full system); the JAX package's carry its pose
    selector before the marginal."""
    state, pg, vis_H, vis_v, linR, lint, *sel, mgd = args
    pg = pg._replace(imu_mask=false(pg.imu_mask), pp_mask=false(pg.pp_mask),
                     pb_mask=false(pg.pb_mask), odo_mask=false(pg.odo_mask))
    mgd = type(mgd)(false(mgd.mask), mgd.lin, zeros(mgd.H), zeros(mgd.v))
    return state, pg, zeros(vis_H), zeros(vis_v), linR, lint, *sel, mgd


def test_gnss_term_alone_matches_jax_and_host():
    """The Cauchy-weighted GNSS term by itself: its information, gradient
    and robust error on the four rows, port against JAX at 1e-5 of their
    scale and against the host f64 GPSFactors at 2e-4 of it; the tail rows'
    weights are over 50 times under the near rows' (measured 89 and 250)."""
    n = 5
    (tm, tvis, _, tvals), (jm, jvis, _, _) = both(n)
    Ht, bt, et = tdg.linearize(*_gnss_only(_port_inputs(tm, tvis, n), torch.zeros_like,
                                           lambda a: torch.zeros_like(a, dtype=torch.bool)))
    Hj, bj, ej = jdg.linearize(*_gnss_only(_jax_inputs(jm, jvis, n), jnp.zeros_like,
                                           lambda a: jnp.zeros_like(a, dtype=bool)))
    Ht, bt, et = Ht.numpy(), bt.numpy(), float(et)
    Hj, bj, ej = np.asarray(Hj), np.asarray(bj), float(ej)
    scale, bscale = np.abs(Hj).max(), np.abs(bj).max()
    assert scale > 0.5 and bscale > 0
    np.testing.assert_allclose(Ht, Hj, atol=1e-5 * scale)
    np.testing.assert_allclose(bt, bj, atol=1e-5 * bscale)
    assert abs(et - ej) < 1e-5 * abs(ej)

    g = PORT.FactorGraph()
    for f in gps_factors(PORT, tm, n):
        g.add(f)
    keys, slices, Hh, bh, errh = g.linearize(tvals)
    perm = perm_to_device(keys, slices, n, NW)
    # the translation rows of the fixes' frames; linearize holds every other
    # row (no information) with a unit diagonal
    rows = np.zeros(NW * 15, bool)
    for i in (0, 1, 3, 4):
        rows[15 * i + 3:15 * i + 6] = True
    sub = np.ix_(rows, rows)
    assert np.abs(Ht[sub] - Hh[np.ix_(perm[rows], perm[rows])]).max() < 2e-4 * scale
    assert np.abs(bt[rows] - bh[perm[rows]]).max() < 2e-4 * bscale
    assert abs(et - errh) < 2e-4 * abs(errh)
    np.testing.assert_array_equal(Ht[~rows][:, ~rows], np.eye(int((~rows).sum())))
    assert not bt[~rows].any() and not Ht[~rows][:, rows].any()
    # the robust weights: the translation block's trace on each row
    tr = [np.trace(Ht[15 * i + 3:15 * i + 6, 15 * i + 3:15 * i + 6]) for i in (0, 1, 3, 4)]
    assert min(tr[:2]) > 50 * max(tr[2:]), tr


def test_lm_optimize_with_gnss_matches_jax_and_host():
    n = 5
    (tm, tvis, tg, tvals), (jm, jvis, _, _) = both(n, perturb_from=1)
    st, (et, it_t) = tdg.lm_optimize(*_port_inputs(tm, tvis, n))
    sj, (ej, it_j) = jax.jit(jdg.lm_optimize)(*_jax_inputs(jm, jvis, n))
    assert it_t == int(it_j) and 1 < it_t <= 24
    for a, b in zip(st[:4], sj[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    res = PORT.LevenbergMarquardt(tg, tvals).optimize()
    for i in range(n):
        assert np.abs(st.t[i].numpy() - res[PORT.X(i)].t).max() < 5e-3
        assert np.abs(st.R[i].numpy() - res[PORT.X(i)].R).max() < 5e-3
        assert np.abs(st.vel[i].numpy() - res[PORT.V(i)]).max() < 5e-3
        assert np.abs(st.bias[i].numpy() - res[PORT.B(i)]).max() < 5e-3


def test_coupled_rounds_with_gnss_match_jax():
    """test_torch_device_graph.py's coupled call with the GNSS rows packed."""
    n, P, B, s0 = 5, NW, NW + 2, 1
    poses, disps, damp, intr, target, weight, ii, jj, mask = _visual_window(3, n, P, B)
    poses = np.roll(poses, s0, 0)
    disps = np.roll(disps, s0, 0)
    out = []
    for p, dg, T in ((PORT, tdg, torch.as_tensor), (JAXP, jdg, jnp.asarray)):
        msba, _ = build_window(p, 7, n)
        add_gnss(p, msba, n)
        fg_flat = dg.pack_state_flat(msba, 0, n, NW)
        pg_flat = dg.pack_graph_flat(msba, 0, n, NW)
        md = dg.marg_dense_np(msba.marg_factor, 0, n, NW)
        args = [T(a.copy()) for a in (poses, disps, damp, intr, target, weight, ii, jj, mask)]
        if p is PORT:
            args[6], args[7] = args[6].long(), args[7].long()
            r = tdg.coupled_rounds_body(
                *args, s0, n, tdg.unflatten_state(T(fg_flat), n, NW),
                tdg.unflatten_graph(T(pg_flat), NW), tdg.marg_to_device(md, "cpu"),
                torch.eye(6), P=P, NW=NW, n_iters=2)
            out.append((r[0].numpy(), r[1].numpy(), tdg.flatten_state(r[2]).numpy(), r[3]))
        else:
            r = jdg.coupled_rounds_device(
                *args, jnp.asarray(s0), jnp.asarray(n), T(fg_flat), T(pg_flat),
                jax.tree.map(jnp.asarray, md), jnp.eye(6), P=P, NW=NW, n_iters=2)
            out.append((np.asarray(r[0]), np.asarray(r[1]), np.asarray(r[2]),
                        [int(x) for x in r[3]]))
    (pt, dt_, ft, it_t), (pj_, dj, fj, it_j) = out
    assert it_t == it_j
    np.testing.assert_allclose(pt, pj_, atol=1e-4)
    np.testing.assert_allclose(dt_, dj, atol=1e-4)
    np.testing.assert_allclose(ft, fj, atol=1e-4)


@pytest.mark.parametrize("m", [2, 4])
def test_marginalize_window_body_with_gnss_matches_jax_and_host(m):
    """Eliminate the first m frames (m = 4 takes both tail fixes): the f32
    Schur complement against the JAX package's and the host
    marginalize_out over the same factors, GPS included."""
    n, P_buf = 6, 12
    h8, w8 = 4, 6
    res = []
    for p, dg, T in ((PORT, tdg, torch.as_tensor), (JAXP, jdg, jnp.asarray)):
        msba, _ = build_window(p, 7, n)
        add_gnss(p, msba, n)
        target = weight = np.zeros((1, h8, w8, 2), np.float32)
        ii = jj = np.zeros(1, np.int32)
        mask = np.zeros(1, bool)
        poses = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32), (P_buf, 1))
        disps = np.ones((P_buf, h8, w8), np.float32)
        damp = np.full((P_buf, h8, w8), 1e-4, np.float32)
        intr = np.asarray([8.0, 8.0, w8 / 2, h8 / 2], np.float32)
        fgf = dg.pack_state_flat(msba, 0, n, NW)
        pgf = dg.pack_graph_flat(msba, 0, n, NW)
        md_old = dg.marg_dense_np(msba.marg_factor, 0, n, NW)
        args = [T(a.copy()) for a in (poses, disps, damp, intr, target, weight, ii, jj, mask)]
        if p is PORT:
            args[6], args[7] = args[6].long(), args[7].long()
            md = tdg.marginalize_window_body(
                *args, 0, tdg.unflatten_state(T(fgf), n, NW), tdg.unflatten_graph(T(pgf), NW),
                tdg.marg_to_device(md_old, "cpu"), torch.eye(6), m, n, P=P_buf, NW=NW)
            res.append(tuple(a.numpy() for a in md))
            vals = host_values(p, msba, n)
            g = p.FactorGraph()
            paras = []
            for i in range(m):
                paras += [p.X(i), p.V(i), p.B(i)]
                g.add(p.CombinedImuFactor(p.X(i), p.V(i), p.X(i + 1), p.V(i + 1), p.B(i),
                                          p.B(i + 1), msba.state.preintegrations[i]))
                if msba.state.odo_valid[i]:
                    g.add(p.VelFactor(p.X(i), p.V(i), msba.state.odo_vel[i], p.ODO_NOISE))
            for f in gps_factors(p, msba, m):
                g.add(f)
            for f in msba.prior_factor_map[0]:
                g.add(f)
            g.add(msba.marg_factor)
            host = tdg.marg_dense_np(p.marginalize_out(g, vals, paras), m, n, NW)
        else:
            md = jdg.marginalize_window_device(
                *args, jnp.asarray(0), T(fgf), T(pgf), jax.tree.map(jnp.asarray, md_old),
                jnp.eye(6), jnp.asarray(m), jnp.asarray(n), jnp.asarray(n), P=P_buf, NW=NW)
            res.append(tuple(np.asarray(a) for a in md))
    (mask_t, lin_t, H_t, v_t), (mask_j, lin_j, H_j, v_j) = res
    scale, vscale = np.abs(H_j).max(), max(np.abs(v_j).max(), 1.0)
    np.testing.assert_array_equal(mask_t, mask_j)
    np.testing.assert_allclose(lin_t, lin_j, atol=1e-6)
    np.testing.assert_allclose(H_t, H_j, atol=1e-4 * scale)
    np.testing.assert_allclose(v_t, v_j, atol=1e-4 * vscale)
    hs = np.abs(host.H).max()
    np.testing.assert_allclose(H_t, host.H, atol=5e-4 * hs)
    np.testing.assert_allclose(v_t, host.v, atol=5e-4 * max(np.abs(host.v).max(), 1.0))
    np.testing.assert_allclose(lin_t[host.mask], host.lin[host.mask], atol=1e-5)
