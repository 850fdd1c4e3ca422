"""The port's device factor graph (``dbaf_tpu_torch/fusion/device_graph.py``,
f32) against the JAX package's, on ``tests/test_device_graph.py``'s window
(IMU chain + pose/bias priors + odometry + a genuine marginal + a visual
hessian), and against the host f64 graph at that file's bounds.

Tolerances.  Port against JAX: both solve in f32 with the same algebra and
sum in another order, so the normal equations agree to 1e-5 of their scale
and the LM and coupled-round states to 1e-4 (measured a few 1e-6).  Port
against the host f64 graph: ``tests/test_device_graph.py``'s bounds (2e-4 of
the scale for the normal equations, 5e-3 for the LM optimum, 5e-4 of the
scale for the marginal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbaf_tpu.fusion import device_graph as jdg
from dbaf_tpu_torch.fusion import device_graph as tdg
from tests.lm_windows import NW, PORT, _perturb, _pkg, build_window, host_values, make_vis
from tests.test_device_graph import perm_to_device


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's eager solve is thousands of small ops: one intra-op thread
    runs them as fast, and keeps parallel test workers from oversubscribing
    the cores (spinning OpenMP threads slow every worker many times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JAXP = _pkg("dbaf_tpu")


def host_graph(p, msba, n, vis_lcf):
    g = p.FactorGraph()
    for i in range(1, n):
        g.add(p.CombinedImuFactor(p.X(i - 1), p.V(i - 1), p.X(i), p.V(i), p.B(i - 1), p.B(i),
                                  msba.state.preintegrations[i - 1]))
    for fs in msba.prior_factor_map.values():
        for f in fs:
            g.add(f)
    g.add(msba.marg_factor)
    for i in range(n):
        if msba.state.odo_valid[i]:
            g.add(p.VelFactor(p.X(i), p.V(i), msba.state.odo_vel[i], p.ODO_NOISE))
    g.add(vis_lcf)
    return g


def _both(n=5, seed=7, perturb_from=0):
    """The same window in both packages: (msba, vis arrays, host graph,
    host values) per package, the port's first."""
    out = []
    for p in (PORT, JAXP):
        msba, rng = build_window(p, seed, n)
        lcf, vis = make_vis(p, rng, msba, n)
        _perturb(p, msba, rng, n, perturb_from)
        out.append((msba, vis, host_graph(p, msba, n, lcf), host_values(p, msba, n)))
    return out


def _port_inputs(msba, vis, n):
    pg = tdg.pack_graph(msba, 0, n, NW)
    mgd = tdg.marg_to_device(tdg.marg_dense_np(msba.marg_factor, 0, n, NW), "cpu")
    return (tdg.pack_state(msba, 0, n, NW), pg, *(torch.as_tensor(a) for a in vis), mgd)


def _jax_inputs(msba, vis, n):
    mgd = jax.tree.map(jnp.asarray, jdg.marg_dense_np(msba.marg_factor, 0, n, NW))
    return (jdg.pack_state(msba, 0, n, NW), jdg.pack_graph(msba, 0, n, NW),
            *(jnp.asarray(a) for a in vis), jdg.make_sel_pose(NW), mgd)


def test_linearize_matches_jax_and_host():
    n = 5
    (tm, tvis, tg, tvals), (jm, jvis, _, _) = _both(n)
    Ht, bt, et = tdg.linearize(*_port_inputs(tm, tvis, n))
    Hj, bj, ej = jdg.linearize(*_jax_inputs(jm, jvis, n))
    Ht, bt, et = Ht.numpy(), bt.numpy(), float(et)
    Hj, bj, ej = np.asarray(Hj), np.asarray(bj), float(ej)
    scale, bscale = np.abs(Hj).max(), max(np.abs(bj).max(), 1.0)
    np.testing.assert_allclose(Ht, Hj, atol=1e-5 * scale)
    np.testing.assert_allclose(bt, bj, atol=1e-5 * bscale)
    assert abs(et - ej) < 1e-5 * max(abs(ej), 1.0)

    # the host f64 graph at tests/test_device_graph.py's bounds
    keys, slices, Hh, bh, errh = tg.linearize(tvals)
    perm = perm_to_device(keys, slices, n, NW)
    live = perm >= 0
    sub = np.ix_(live, live)
    assert np.abs(Ht[sub] - Hh[np.ix_(perm[live], perm[live])]).max() < 2e-4 * scale
    assert np.abs(bt[live] - bh[perm[live]]).max() < 2e-4 * max(np.abs(bh).max(), 1.0)
    assert abs(et - errh) < 2e-4 * max(abs(errh), 1.0)


def test_lm_optimize_matches_jax_and_host():
    n = 5
    (tm, tvis, tg, tvals), (jm, jvis, _, _) = _both(n, perturb_from=1)
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


def test_failed_cholesky_is_a_rejected_zero_step_as_in_jax():
    """A non-positive-definite damped system: JAX's cho_factor gives NaN and
    the step is rejected; torch's cholesky_ex returns a partial factor whose
    solve is finite, so the port must reject on ``info > 0``.  Expected on
    both: the state unchanged, the step rejected (lambda x 10), and the loop
    done after one iteration (the unchanged error is a plateau)."""
    n = 5
    (tm, tvis, _, _), (jm, jvis, _, _) = _both(n)
    neg = lambda vis, m: (m(-1e6 * np.eye(NW * 6, dtype=np.float32)),) + vis[1:]  # noqa: E731
    targs = list(_port_inputs(tm, tvis, n))
    jargs = list(_jax_inputs(jm, jvis, n))
    targs[2:6] = neg(tuple(targs[2:6]), torch.as_tensor)
    jargs[2:6] = neg(tuple(jargs[2:6]), jnp.asarray)
    state = targs[0]

    def relin(s):
        return tdg.linearize(s, *targs[1:])

    H, b, err = relin(state)
    lam = torch.tensor(1e-5)
    L, info = torch.linalg.cholesky_ex(H + lam * torch.diag(torch.diagonal(H)))
    assert int(info) > 0
    assert torch.isfinite(torch.cholesky_solve(b[:, None], L)).all()  # the trap
    s = tdg.lm_step(state, H, b, lam, err, relin)
    assert not bool(s.ok) and not bool(s.accept) and bool(s.done)
    assert float(s.lam) == pytest.approx(1e-4)
    for a, b_ in zip(s.state[:4], state[:4]):
        assert torch.equal(a, b_)

    st, (_, it_t) = tdg.lm_optimize(*targs)
    sj, (_, it_j) = jax.jit(jdg.lm_optimize)(*jargs)
    assert it_t == int(it_j) == 1
    for a, b_, c in zip(st[:4], sj[:4], state[:4]):
        assert torch.equal(a, c)
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=1e-6)


def _visual_window(seed, n, P, B):
    """Camera poses of the window's body states (Tbc = identity) in a B-slot
    buffer, plane disparities, and targets from slightly perturbed poses."""
    from dbaf_tpu.ops import lie as jl
    from dbaf_tpu.ops import projective as jp

    msba, rng = build_window(JAXP, seed, n)
    h8, w8 = 4, 6
    poses = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32), (B, 1))
    for i in range(n):
        Tcw = np.linalg.inv(msba.state.wTbs[i].matrix())
        poses[i] = np.asarray(jl.se3_from_matrix(jnp.asarray(Tcw, jnp.float32)))
    disps = (0.5 + 0.05 * rng.random((B, h8, w8))).astype(np.float32)
    damp = np.full((B, h8, w8), 1e-4, np.float32)
    intr = np.asarray([8.0, 8.0, w8 / 2, h8 / 2], np.float32)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    keep = ii != jj
    ii, jj = ii[keep].astype(np.int32), jj[keep].astype(np.int32)
    noisy = poses.copy()
    noisy[:n, :3] += 0.01 * rng.standard_normal((n, 3)).astype(np.float32)
    target, _ = jp.projective_transform(jnp.asarray(noisy), jnp.asarray(disps),
                                        jnp.asarray(intr), jnp.asarray(ii), jnp.asarray(jj))
    weight = rng.uniform(0.5, 1.0, size=np.shape(target)).astype(np.float32)
    return (poses, disps, damp, intr, np.asarray(target), weight, ii, jj,
            np.ones(len(ii), bool))


def test_coupled_rounds_body_matches_jax():
    """One coupled call: reduced camera system -> body -> factor-graph LM ->
    camera step -> depth back-substitution, two passes with
    relinearization; the buffers' window sits at slot 1."""
    n, P, B, s0 = 5, NW, NW + 2, 1
    vis = _visual_window(3, n, P, B)
    poses, disps, damp, intr, target, weight, ii, jj, mask = vis
    poses = np.roll(poses, s0, 0)
    disps = np.roll(disps, s0, 0)
    out = []
    for p, dg, T in ((PORT, tdg, torch.as_tensor), (JAXP, jdg, jnp.asarray)):
        msba, _ = build_window(p, 7, n)
        fg_flat = dg.pack_state_flat(msba, 0, n, NW)
        pg_flat = dg.pack_graph_flat(msba, 0, n, NW)
        md = dg.marg_dense_np(msba.marg_factor, 0, n, NW)
        # copies: the port writes the window back into its buffers in place
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
    assert np.abs(pt - poses).max() > 1e-5  # it moved
    np.testing.assert_allclose(pt, pj_, atol=1e-4)
    np.testing.assert_allclose(dt_, dj, atol=1e-4)
    np.testing.assert_allclose(ft, fj, atol=1e-4)
    np.testing.assert_array_equal(pt[:s0], poses[:s0])  # outside the window


@pytest.mark.parametrize("visual", [False, True])
def test_marginalize_window_body_matches_jax_and_host(visual):
    """Eliminate the first m frames of the window (IMU + priors + odometry +
    old marginal, and with ``visual`` the hessian of edges on them): the
    Jacobi-scaled f32 Schur complement against the JAX package's, and
    without visual edges against the host marginalize_out
    (tests/test_device_graph.py:248's case)."""
    n, m, P_buf = 6, 2, 12
    res = []
    for p, dg, T in ((PORT, tdg, torch.as_tensor), (JAXP, jdg, jnp.asarray)):
        msba, _ = build_window(p, 7, n)
        if visual:
            poses, disps, damp, intr, target, weight, ii, jj, mask = _visual_window(
                3, n, P_buf, P_buf)
            mask = mask & ((ii < m) | (jj < m))
        else:
            h8, w8 = 4, 6
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
        else:
            md = jdg.marginalize_window_device(
                *args, jnp.asarray(0), T(fgf), T(pgf), jax.tree.map(jnp.asarray, md_old),
                jnp.eye(6), jnp.asarray(m), jnp.asarray(n), jnp.asarray(n), P=P_buf, NW=NW)
            res.append(tuple(np.asarray(a) for a in md))
        if p is PORT and not visual:
            vals = host_values(p, msba, n)
            g = p.FactorGraph()
            paras = []
            for i in range(m):
                paras += [p.X(i), p.V(i), p.B(i)]
                g.add(p.CombinedImuFactor(p.X(i), p.V(i), p.X(i + 1), p.V(i + 1), p.B(i),
                                          p.B(i + 1), msba.state.preintegrations[i]))
                if msba.state.odo_valid[i]:
                    g.add(p.VelFactor(p.X(i), p.V(i), msba.state.odo_vel[i], p.ODO_NOISE))
            for f in msba.prior_factor_map[0]:
                g.add(f)
            g.add(msba.marg_factor)
            host = tdg.marg_dense_np(p.marginalize_out(g, vals, paras), m, n, NW)
    (mask_t, lin_t, H_t, v_t), (mask_j, lin_j, H_j, v_j) = res
    scale, vscale = np.abs(H_j).max(), max(np.abs(v_j).max(), 1.0)
    assert scale > 0
    np.testing.assert_array_equal(mask_t, mask_j)
    np.testing.assert_allclose(lin_t, lin_j, atol=1e-6)
    np.testing.assert_allclose(H_t, H_j, atol=1e-4 * scale)
    np.testing.assert_allclose(v_t, v_j, atol=1e-4 * vscale)
    if not visual:
        hs = np.abs(host.H).max()
        np.testing.assert_allclose(H_t, host.H, atol=5e-4 * hs)
        np.testing.assert_allclose(v_t, host.v, atol=5e-4 * max(np.abs(host.v).max(), 1.0))
        np.testing.assert_allclose(lin_t[host.mask], host.lin[host.mask], atol=1e-5)
