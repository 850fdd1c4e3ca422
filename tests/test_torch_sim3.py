"""The port's Sim(3) group (``dbaf_tpu_torch/ops/sim3.py``), the Sim3
branch of its ``projective_transform`` and the Sim3 geodesic loss, held
against the JAX package on the same numpy inputs, with the non-slow cases
of ``tests/test_sim3.py`` (``:20,32,54,65,85,99,192``) run through the port.

Tolerances: f32 on both sides, so every function agrees with the JAX one to
a few f32 ulps of its result's scale (atol 2e-5 on unit-scale outputs,
1e-4 on reprojected pixel coordinates and on the 3 x 3 solve of the log),
and each case's own check keeps the JAX test's bound.
"""

import jax.numpy as jnp
import numpy as np
import torch

from dbaf_tpu.ops import lie as jlie
from dbaf_tpu.ops import projective as jpj
from dbaf_tpu.ops import sim3 as jsim3
from dbaf_tpu_torch.ops import lie, projective as pj, sim3

T = torch.as_tensor


def _xi_sim3(rng, n=8, max_angle=2.5):
    """tests/test_sim3.py::_rand_sim3's tangent vectors."""
    xi = rng.normal(size=(n, 7)).astype(np.float64)
    xi[:, 3:6] *= max_angle / 2.5
    xi[:, 6] *= 0.4
    return xi.astype(np.float32)


def _both(rng, n=8):
    xi = _xi_sim3(rng, n)
    return jsim3.exp(jnp.asarray(xi)), sim3.exp(T(xi))


def test_exp_log_roundtrip():
    rng = np.random.default_rng(0)
    xi = rng.normal(size=(64, 7)).astype(np.float32)
    xi[:16, 3:6] *= 1e-6
    xi[16:32, 6] *= 1e-7
    xi[32:40, 3:6] *= 1e-6
    xi[32:40, 6] *= 1e-7
    g = sim3.exp(T(xi))
    np.testing.assert_allclose(g.numpy(), np.asarray(jsim3.exp(jnp.asarray(xi))), atol=2e-5)
    xi2 = sim3.log(g).numpy()
    np.testing.assert_allclose(xi2, xi, atol=3e-5)
    np.testing.assert_allclose(xi2, np.asarray(jsim3.log(jnp.asarray(g.numpy()))), atol=1e-4)


def test_group_axioms():
    rng = np.random.default_rng(0)
    ja, a = _both(rng)
    jb, b = _both(rng)
    ident = sim3.identity((8,))
    np.testing.assert_allclose(ident.numpy(), np.asarray(jsim3.identity((8,))))
    np.testing.assert_allclose(sim3.mul(a, sim3.inv(a)).numpy(), ident.numpy(), atol=1e-5)
    np.testing.assert_allclose(sim3.mul(a, b).numpy(), np.asarray(jsim3.mul(ja, jb)), atol=2e-5)
    np.testing.assert_allclose(sim3.inv(a).numpy(), np.asarray(jsim3.inv(ja)), atol=2e-5)
    np.testing.assert_allclose(sim3.rel(a, b).numpy(), np.asarray(jsim3.rel(ja, jb)), atol=2e-5)
    xi = 0.3 * _xi_sim3(rng)
    np.testing.assert_allclose(sim3.retr(a, T(xi)).numpy(),
                               np.asarray(jsim3.retr(ja, jnp.asarray(xi))), atol=2e-5)

    def mat(g):
        g = np.asarray(g, np.float64)
        R = lie.quat_to_matrix(T(g[..., 3:7]).float()).double().numpy()
        M = np.zeros(g.shape[:-1] + (4, 4))
        M[..., :3, :3] = g[..., 7:8, None] * R
        M[..., :3, 3] = g[..., :3]
        M[..., 3, 3] = 1.0
        return M

    np.testing.assert_allclose(mat(sim3.mul(a, b)), mat(a) @ mat(b), atol=1e-4)
    np.testing.assert_allclose(sim3.to_se3(a).numpy(), np.asarray(jsim3.to_se3(ja)), atol=2e-5)


def test_act_matches_matrix():
    rng = np.random.default_rng(0)
    jg, g = _both(rng, 4)
    x = rng.normal(size=(4, 3)).astype(np.float32)
    out = sim3.act(g, T(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jsim3.act(jg, jnp.asarray(x))), atol=2e-5)
    X = rng.normal(size=(4, 4)).astype(np.float32)
    np.testing.assert_allclose(sim3.act4(g, T(X)).numpy(),
                               np.asarray(jsim3.act4(jg, jnp.asarray(X))), atol=2e-5)
    for k in range(4):
        gk = g[k].double().numpy()
        R = lie.quat_to_matrix(g[k, 3:7]).double().numpy()
        np.testing.assert_allclose(out[k], gk[7] * R @ x[k].astype(np.float64) + gk[:3],
                                   atol=1e-5)


def test_unit_scale_reduces_to_se3():
    rng = np.random.default_rng(0)
    g7 = lie.se3_exp(T(rng.normal(size=(6, 6)).astype(np.float32)))
    g8 = sim3.from_se3(g7)
    np.testing.assert_allclose(g8.numpy(), np.asarray(jsim3.from_se3(jnp.asarray(g7.numpy()))))
    X = T(rng.normal(size=(6, 4)).astype(np.float32))
    np.testing.assert_allclose(sim3.act4(g8, X).numpy(), lie.se3_act4(g7, X).numpy(), atol=1e-6)
    a = rng.normal(size=(6, 7)).astype(np.float32)
    adj = sim3.adjT(g8, T(a)).numpy()
    np.testing.assert_allclose(adj[:, :6], lie.se3_adjT(g7, T(a[:, :6])).numpy(), atol=1e-5)
    np.testing.assert_allclose(adj, np.asarray(jsim3.adjT(jnp.asarray(g8.numpy()),
                                                          jnp.asarray(a))), atol=2e-5)
    l8 = sim3.log(g8).numpy()
    np.testing.assert_allclose(l8[:, :6], lie.se3_log(g7).numpy(), atol=2e-5)
    np.testing.assert_allclose(l8[:, 6], 0.0, atol=1e-6)


def test_adjoint_identity():
    """Ad_g xi = log(g exp(xi) g^-1), adjT its transpose (autograd's
    Jacobian in the port, jacfwd's in the JAX test)."""
    rng = np.random.default_rng(0)
    g = sim3.exp(T(_xi_sim3(rng, 1)))[0]

    def conj(xi):
        return sim3.log(sim3.mul(sim3.mul(g, sim3.exp(xi)), sim3.inv(g)))

    Ad = torch.autograd.functional.jacobian(conj, torch.zeros(7)).numpy()
    a = rng.normal(size=(7,)).astype(np.float32)
    np.testing.assert_allclose(sim3.adjT(g, T(a)).numpy(), Ad.T @ a, atol=1e-4)


def test_projective_transform_sim3():
    """8-wide poses through projective_transform: s = 1 matches SE3, s != 1
    matches the JAX package and a numpy reprojection."""
    rng = np.random.default_rng(0)
    N, H, W = 4, 6, 8
    intr = np.asarray([10.0, 10.0, W / 2, H / 2], np.float32)
    poses7 = lie.se3_exp(T(0.1 * rng.normal(size=(N, 6)).astype(np.float32)))
    disps = (0.5 + 0.1 * rng.random((N, H, W))).astype(np.float32)
    ii, jj = np.asarray([0, 1, 2]), np.asarray([1, 2, 3])
    args = (T(disps), T(intr), T(ii), T(jj))
    c7, v7 = pj.projective_transform(poses7, *args)
    c8, v8 = pj.projective_transform(sim3.from_se3(poses7), *args)
    np.testing.assert_allclose(c8.numpy(), c7.numpy(), atol=1e-4)
    np.testing.assert_array_equal(v8.numpy(), v7.numpy())

    scales = np.asarray([1.0, 1.3, 0.8, 1.1], np.float32)
    poses8 = torch.cat([poses7, T(scales)[:, None]], dim=-1)
    c, v = pj.projective_transform(poses8, *args)
    jc, jv = jpj.projective_transform(jnp.asarray(poses8.numpy()), jnp.asarray(disps),
                                      jnp.asarray(intr), jnp.asarray(ii), jnp.asarray(jj))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-4)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    fx, fy, cx, cy = intr
    for e, (i, j) in enumerate(zip(ii, jj)):
        gij = sim3.rel(poses8[i], poses8[j]).double().numpy()
        R = lie.quat_to_matrix(T(gij[3:7]).float()).double().numpy()
        for y in range(H):
            for x in range(W):
                p = np.array([(x - cx) / fx, (y - cy) / fy, 1.0])
                p1 = gij[7] * R @ p + float(disps[i, y, x]) * gij[:3]
                if p1[2] <= 0.2:
                    continue
                np.testing.assert_allclose(
                    c[e, y, x].numpy(), [fx * p1[0] / p1[2] + cx, fy * p1[1] / p1[2] + cy],
                    atol=1e-3)


def test_geodesic_loss_sim3():
    from dbaf_tpu.train.losses import geodesic_loss as jgeo
    from dbaf_tpu_torch.train.losses import geodesic_loss

    rng = np.random.default_rng(0)
    N = 6
    Ps = lie.se3_exp(T(0.3 * rng.normal(size=(N, 6)).astype(np.float32)))
    ii, jj = T(np.arange(5)), T(np.arange(1, 6))
    jPs, jii, jjj = jnp.asarray(Ps.numpy()), jnp.asarray(ii.numpy()), jnp.asarray(jj.numpy())

    def check(G, do_scale):
        loss, m = geodesic_loss(Ps, [G], ii, jj, do_scale=do_scale)
        jloss, jm = jgeo(jPs, [jnp.asarray(G.numpy())], jii, jjj, do_scale=do_scale)
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
        assert set(m) == set(jm)
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=2e-4, err_msg=k)
        return loss, m

    loss0, m0 = check(sim3.from_se3(Ps), False)
    assert float(loss0) < 1e-4
    assert float(m0["scale_error"]) < 1e-5
    drift = torch.cat([Ps, torch.full((N, 1), 1.2)], dim=-1)
    _, m1 = check(drift, False)
    assert float(m1["scale_error"]) < 1e-5
    s = T(np.asarray([1.0, 1.1, 1.2, 1.3, 1.4, 1.5], np.float32))
    loss2, m2 = check(torch.cat([Ps, s[:, None]], dim=-1), False)
    assert float(m2["scale_error"]) > 0.05
    assert float(loss2) > float(loss0)
    check(torch.cat([Ps, s[:, None]], dim=-1), True)
    _, m3 = check(Ps, True)
    assert float(m3["rot_error"]) < 1e-3


def test_projection_jacobians_sim3():
    """projection_jacobians_sim3 against the JAX function (f32: 1e-4 on
    pixels and Jacobian entries) and against the port's own autograd of the
    Sim3 reprojection under the left-perturbation convention, at the bound
    of tests/test_sim3.py:143 (2e-3)."""
    rng = np.random.default_rng(3)
    N, H, W = 3, 4, 6
    intr = np.asarray([8.0, 8.0, W / 2, H / 2], np.float32)
    p8 = sim3.exp(T(_xi_sim3(rng, N, max_angle=0.3)))
    poses8 = torch.cat([0.2 * p8[:, :3], p8[:, 3:7], p8[:, 7:].clamp(0.7, 1.4)], -1)
    disps = T((0.6 + 0.1 * rng.random((N, H, W))).astype(np.float32))
    ii, jj = T(np.asarray([0, 1, 2])), T(np.asarray([1, 2, 2]))  # with a stereo edge
    J = pj.projection_jacobians_sim3(poses8, disps, T(intr), ii, jj)
    Jj_ = jpj.projection_jacobians_sim3(jnp.asarray(poses8.numpy()), jnp.asarray(disps.numpy()),
                                        jnp.asarray(intr), jnp.asarray(ii.numpy()),
                                        jnp.asarray(jj.numpy()))
    for name in ("coords", "Ji", "Jj", "Jz"):
        np.testing.assert_allclose(getattr(J, name).numpy(), np.asarray(getattr(Jj_, name)),
                                   atol=1e-4, rtol=1e-5, err_msg=name)
    np.testing.assert_array_equal(J.valid.numpy(), np.asarray(Jj_.valid))

    def coords_fn(xi_j, xi_i, dd):
        p = torch.stack([sim3.retr(poses8[0], xi_i), sim3.retr(poses8[1], xi_j), poses8[2]])
        d = torch.cat([(disps[0] + dd)[None], disps[1:]])
        return pj.projective_transform(p, d, T(intr), ii[:1], jj[:1])[0][0]

    z7 = torch.zeros(7)
    Jj_num = torch.autograd.functional.jacobian(lambda x: coords_fn(x, z7, 0.0), z7).numpy()
    Ji_num = torch.autograd.functional.jacobian(lambda x: coords_fn(z7, x, 0.0), z7).numpy()
    Jz_num = torch.autograd.functional.jacobian(
        lambda x: coords_fn(z7, z7, x), torch.zeros(H, W)).numpy()
    m = J.valid[0].numpy()[..., None, None]
    np.testing.assert_allclose(J.Jj[0].numpy() * m, Jj_num * m, atol=2e-3)
    np.testing.assert_allclose(J.Ji[0].numpy() * m, Ji_num * m, atol=2e-3)
    Jz_diag = np.stack([np.stack([Jz_num[y, x, :, y, x] for x in range(W)]) for y in range(H)])
    np.testing.assert_allclose(J.Jz[0].numpy() * m[..., 0], Jz_diag * m[..., 0], atol=2e-3)
