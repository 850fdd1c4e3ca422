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
