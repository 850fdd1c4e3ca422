"""Port parity for dense BA: dbaf_tpu_torch.ops.dba.ba against
dbaf_tpu.ops.dba.ba on a small synthetic window (f32, CPU).

Tolerance ``atol 1e-4`` on poses and disparities after two Gauss-Newton
iterations: both sides run the same f32 algebra, the port's segment sums
(``index_add_``) and Gram products sum in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbaf_tpu.ops import dba as jd
from dbaf_tpu.ops import lie as jl
from dbaf_tpu.ops import projective as jp
from dbaf_tpu_torch.ops import dba as td


def _problem(seed, P=5, ht=6, wd=8):
    rng = np.random.default_rng(seed)
    xi = np.concatenate([0.15 * rng.normal(size=(P, 3)), 0.05 * rng.normal(size=(P, 3))], -1)
    xi[0] = 0.0
    gt = np.asarray(jl.se3_exp(jnp.asarray(xi, jnp.float32)))
    disps_gt = (0.6 + 0.2 * rng.random((P, ht, wd))).astype(np.float32)
    intr = np.asarray([20.0, 20.0, wd / 2, ht / 2], np.float32)
    ii, jj = np.meshgrid(np.arange(P), np.arange(P), indexing="ij")
    keep = (np.abs(ii - jj) >= 1) & (np.abs(ii - jj) <= 2)
    ii, jj = ii[keep], jj[keep]
    # one stereo self-edge and two padded (masked) edges
    ii = np.concatenate([ii, [2, 0, 0]]).astype(np.int64)
    jj = np.concatenate([jj, [2, 0, 0]]).astype(np.int64)
    mask = np.ones(len(ii), bool)
    mask[-2:] = False
    targets, _ = jp.projective_transform(jnp.asarray(gt), jnp.asarray(disps_gt),
                                         jnp.asarray(intr), jnp.asarray(ii), jnp.asarray(jj))
    targets = np.asarray(targets) + 0.3 * rng.normal(size=np.shape(targets)).astype(np.float32)
    weights = rng.uniform(0.2, 1.0, size=targets.shape).astype(np.float32)
    # perturbed start
    noise = np.concatenate([0.02 * rng.normal(size=(P, 3)), 0.01 * rng.normal(size=(P, 3))], -1)
    poses0 = np.asarray(jl.se3_retr(jnp.asarray(gt), jnp.asarray(noise, jnp.float32)))
    disps0 = (disps_gt * (1 + 0.05 * rng.normal(size=disps_gt.shape))).astype(np.float32)
    eta = (1e-3 + 1e-4 * rng.random((P, ht * wd))).astype(np.float32)
    return poses0, disps0, intr, targets.astype(np.float32), weights, eta, ii, jj, mask


@pytest.mark.parametrize("schur,motion_only", [("pairwise", False), ("dense", False),
                                               ("dense", True)])
def test_ba_matches_jax(schur, motion_only):
    poses0, disps0, intr, targets, weights, eta, ii, jj, mask = _problem(7)
    nfixed, nactive = 1, 5
    args = (poses0, disps0, intr, targets, weights, eta, ii, jj, mask)
    kw = dict(iterations=2, schur=schur, motion_only=motion_only)
    jout = jd.ba(*(jnp.asarray(a) for a in args), jnp.asarray(nfixed), jnp.asarray(nactive), **kw)
    tout = td.ba(*(torch.tensor(a) for a in args), nfixed, nactive, **kw)
    np.testing.assert_allclose(tout.poses.numpy(), np.asarray(jout.poses), atol=1e-4)
    np.testing.assert_allclose(tout.disps.numpy(), np.asarray(jout.disps), atol=1e-4)
    assert not np.allclose(tout.poses.numpy(), poses0, atol=1e-6)  # it moved


def test_pairwise_equals_dense_schur():
    poses0, disps0, intr, targets, weights, eta, ii, jj, mask = _problem(8)
    P = poses0.shape[0]
    t = [torch.tensor(a) for a in (poses0, disps0, intr, targets, weights)]
    ii_t, jj_t, m_t = torch.tensor(ii), torch.tensor(jj), torch.tensor(mask)
    es = td.build_edge_system(*t, ii_t, jj_t, m_t)
    ps = td.assemble_pairwise(es, ii_t, jj_t, P, 1, P, torch.tensor(eta))
    ws = td.assemble_window_system(es, ii_t, jj_t, P, 1, P, torch.tensor(eta))
    S, v = td.reduced_camera_system(ws)
    scale = S.abs().max().item()
    np.testing.assert_allclose(ps.S.numpy(), S.numpy(), atol=1e-5 * scale)
    np.testing.assert_allclose(ps.v.numpy(), v.numpy(), atol=1e-5 * max(v.abs().max().item(), 1e-9))


def test_indefinite_system_gives_zero_step():
    P = 3
    S = -torch.eye(6 * P)  # negative definite: Cholesky fails
    v = torch.ones(6 * P)
    dx = td.damped_solve(S, v, torch.ones(P, dtype=torch.bool), 1e-4, 0.1)
    assert torch.equal(dx, torch.zeros_like(dx))
    good = td.damped_solve(torch.eye(6 * P), v, torch.ones(P, dtype=torch.bool), 0.0, 0.0)
    np.testing.assert_allclose(good.numpy(), np.ones(6 * P), atol=1e-6)


def _buffers(seed, B=8, s0=2):
    """_problem's window placed at slot s0 of B-slot buffers (the other
    slots hold unrelated frames), with a damping buffer."""
    poses0, disps0, intr, targets, weights, eta, ii, jj, mask = _problem(seed)
    P = poses0.shape[0]
    rng = np.random.default_rng(seed + 100)
    poses_buf = np.tile(poses0[:1], (B, 1))
    poses_buf[:, :3] += 0.1 * rng.normal(size=(B, 3)).astype(np.float32)
    poses_buf[s0:s0 + P] = poses0
    disps_buf = np.ones((B,) + disps0.shape[1:], np.float32)
    disps_buf[s0:s0 + P] = disps0
    damp_buf = (1e-3 * rng.random(disps_buf.shape)).astype(np.float32)
    return poses_buf, disps_buf, damp_buf, intr, targets, weights, ii, jj, mask, P


@pytest.mark.parametrize("full", [False, True])
def test_coupled_hessian_matches_jax(full):
    """BACore::hessian: the undamped reduced camera system, every slot below
    nactive free.  Tolerance 1e-5 of the system's scale (f32 Gram products
    and segment sums in another order)."""
    pb, db, damp, intr, targets, weights, ii, jj, mask, P = _buffers(3)
    s0, nactive = 2, 4
    if full:
        args = (pb, db, damp, intr, targets, weights, ii, jj, mask)
        Sj, vj = jd.coupled_hessian_full(*(jnp.asarray(a) for a in args), jnp.asarray(s0),
                                         jnp.asarray(nactive), P=P)
        St, vt = td.coupled_hessian_full(*(torch.tensor(a) for a in args), s0, nactive, P=P)
    else:
        eta = (0.2 * damp[s0:s0 + P].reshape(P, -1) + 1e-7).astype(np.float32)
        args = (pb[s0:s0 + P], db[s0:s0 + P], intr, targets, weights, eta, ii, jj, mask)
        Sj, vj = jd.coupled_hessian(*(jnp.asarray(a) for a in args), jnp.asarray(nactive))
        St, vt = td.coupled_hessian(*(torch.tensor(a) for a in args), nactive)
    Sj, vj = np.asarray(Sj), np.asarray(vj)
    assert np.abs(Sj[6 * nactive:]).max() < np.abs(Sj).max()  # inactive slots carry damping only
    np.testing.assert_allclose(St.numpy(), Sj, atol=1e-5 * np.abs(Sj).max())
    np.testing.assert_allclose(vt.numpy(), vj, atol=1e-5 * np.abs(vj).max())


@pytest.mark.parametrize("full", [False, True])
def test_coupled_retract_matches_jax(full):
    """BACore::retract: an external pose step and the depth update it
    induces; ``_full`` writes the window back in place and relinearizes.
    Poses and disparities to 1e-5, the next system to 1e-5 of its scale."""
    pb, db, damp, intr, targets, weights, ii, jj, mask, P = _buffers(4)
    s0, nactive = 2, 4
    rng = np.random.default_rng(9)
    dx = (1e-2 * rng.normal(size=(P, 6))).astype(np.float32)
    if full:
        args = (pb, db, damp, intr, targets, weights, ii, jj, mask)
        pj_, dj_, Sj, vj = jd.coupled_retract_full(
            *(jnp.asarray(a) for a in args), jnp.asarray(s0), jnp.asarray(nactive),
            jnp.asarray(dx), P=P, with_hessian=True)
        pt, dt_, St, vt = td.coupled_retract_full(
            *(torch.tensor(a) for a in args), s0, nactive, torch.tensor(dx), P=P,
            with_hessian=True)
        np.testing.assert_allclose(St.numpy(), np.asarray(Sj), atol=1e-5 * np.abs(Sj).max())
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-5 * np.abs(vj).max())
        np.testing.assert_array_equal(pt.numpy()[:s0], pb[:s0])  # outside the window: untouched
    else:
        eta = (0.2 * damp[s0:s0 + P].reshape(P, -1) + 1e-7).astype(np.float32)
        args = (pb[s0:s0 + P], db[s0:s0 + P], intr, targets, weights, eta, ii, jj, mask)
        pj_, dj_ = jd.coupled_retract(*(jnp.asarray(a) for a in args), jnp.asarray(nactive),
                                      jnp.asarray(dx))
        pt, dt_ = td.coupled_retract(*(torch.tensor(a) for a in args), nactive,
                                     torch.tensor(dx))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj_), atol=1e-5)
    np.testing.assert_allclose(dt_.numpy(), np.asarray(dj_), atol=1e-5)


def test_window_rows_slot_keeps_its_frame_past_the_buffer_end():
    """Where [s0, s0 + P) fits the buffer, the window is the slice
    jax.lax.dynamic_slice takes.  Past the end, dynamic_slice moves the
    start down to B - P, so slot l stops holding frame s0 + l; the port keeps
    slot l = frame s0 + l and pads the slots past the end with the last row
    (they carry no edge)."""
    import jax

    buf = np.arange(10 * 7, dtype=np.float32).reshape(10, 7)
    for s0, P in ((2, 5), (5, 5), (7, 5)):
        got = td.window_rows(torch.tensor(buf), s0, P).numpy()
        ref = np.asarray(jax.lax.dynamic_slice(jnp.asarray(buf), (s0, 0), (P, 7)))
        if s0 + P <= 10:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_array_equal(got[: 10 - s0], buf[s0:])
            np.testing.assert_array_equal(got[10 - s0:], np.repeat(buf[-1:], s0 + P - 10, 0))
            assert not np.array_equal(ref[0], buf[s0])  # the JAX slice starts at B - P
    out = torch.zeros(10, 7)
    td.write_window_rows(out, torch.ones(5, 7), 7)
    assert out[7:].eq(1).all() and out[:7].eq(0).all()
