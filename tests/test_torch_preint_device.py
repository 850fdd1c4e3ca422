"""The port's device preintegration chunks (``dbaf_tpu_torch/fusion/
preint_device.py``) against the JAX package's (``dbaf_tpu/fusion/
preint_device.py``) and the host integration, on the seeded measurements of
``tests/test_preint_device.py`` and at its tolerances: composition against
sequential integration (2e-5 of each field's scale, the covariance to 5e-4
Jacobi-scaled), associativity, identity, the mixed-bias first order (5e-4),
pack/unpack (exact), predict (2e-5) and the information matrix (2e-3
Jacobi-scaled).  Both packages work in f32, so each port result is held to
the JAX one at the same tolerance as to the host.
"""

import types

import jax.numpy as jnp
import numpy as np
import torch

from dbaf_tpu.fusion import preint_device as jpd
from dbaf_tpu.fusion.preintegration import ImuParams
from dbaf_tpu_torch.fusion import preint_device as tpd
from tests.test_preint_device import assert_chunk_close, integrate_host, make_meas

BIAS = np.asarray([0.02, -0.01, 0.03, 0.002, -0.001, 0.004])


def chunks(pim):
    """The same host integration as a JAX chunk and a port chunk."""
    row = jpd.pack_chunk_np(pim)
    return jpd.unpack_chunk(jnp.asarray(row)), tpd.unpack_chunk(torch.as_tensor(row))


def both(pim, jc, tc, tol=2e-5):
    """Port and JAX composed chunks against the host and each other."""
    assert_chunk_close(tc, pim, tol)
    assert_chunk_close(jc, pim, tol)
    jax_as_host = types.SimpleNamespace(**{k: np.asarray(v, np.float64)
                                           for k, v in jc._asdict().items()})
    jax_as_host.dt = float(jc.dt)
    assert_chunk_close(tc, jax_as_host, tol)


def test_compose_matches_sequential_integration(rng):
    acc, gyro, dts = make_meas(rng, 60)
    full = integrate_host(acc, gyro, dts, BIAS)
    for k in (1, 17, 30, 59):
        jA, tA = chunks(integrate_host(acc[:k], gyro[:k], dts[:k], BIAS))
        jB, tB = chunks(integrate_host(acc[k:], gyro[k:], dts[k:], BIAS))
        both(full, jpd.compose(jA, jB), tpd.compose(tA, tB))


def test_compose_associative_three_way(rng):
    acc, gyro, dts = make_meas(rng, 45)
    full = integrate_host(acc, gyro, dts, np.zeros(6))
    cs = [chunks(integrate_host(acc[a:b], gyro[a:b], dts[a:b], np.zeros(6)))
          for a, b in ((0, 15), (15, 30), (30, 45))]
    for m, k in ((jpd, 0), (tpd, 1)):
        c0, c1, c2 = (c[k] for c in cs)
        assert_chunk_close(m.compose(m.compose(c0, c1), c2), full)
        assert_chunk_close(m.compose(c0, m.compose(c1, c2)), full)


def test_compose_identity(rng):
    bias = np.asarray([0.01, 0.0, -0.02, 0.001, 0.002, 0.0])
    acc, gyro, dts = make_meas(rng, 20)
    pim = integrate_host(acc, gyro, dts, bias)
    jc, tc = chunks(pim)
    eye = tpd.identity_chunk(torch.as_tensor(bias, dtype=torch.float32))
    assert_chunk_close(tpd.compose(eye, tc), pim)
    assert_chunk_close(tpd.compose(tc, eye), pim)
    both(pim, jpd.compose(jpd.identity_chunk(bias), jc), tpd.compose(eye, tc))


def test_compose_mixed_bias_first_order(rng):
    db = 1e-3 * np.asarray([1.0, -2.0, 0.5, 0.8, -0.3, 1.2])
    acc, gyro, dts = make_meas(rng, 40)
    full = integrate_host(acc, gyro, dts, BIAS)
    jA, tA = chunks(integrate_host(acc[:20], gyro[:20], dts[:20], BIAS))
    jB, tB = chunks(integrate_host(acc[20:], gyro[20:], dts[20:], BIAS + db))
    both(full, jpd.compose(jA, jB), tpd.compose(tA, tB), tol=5e-4)


def test_pack_unpack_roundtrip(rng):
    acc, gyro, dts = make_meas(rng, 25)
    pim = integrate_host(acc, gyro, dts, np.asarray([0.1] * 6))
    row = tpd.pack_chunk_np(pim)
    assert row.shape == (tpd.CHUNK_FLAT,)
    np.testing.assert_array_equal(row, jpd.pack_chunk_np(pim))
    back = tpd.flatten_chunk(tpd.unpack_chunk(torch.as_tensor(row))).numpy()
    np.testing.assert_array_equal(back, row)


def test_predict_matches_host_and_jax(rng):
    from dbaf_tpu.fusion.preintegration import NavState
    from dbaf_tpu.fusion.se3np import Pose, so3_exp

    bias_now = BIAS + 5e-3
    acc, gyro, dts = make_meas(rng, 30)
    pim = integrate_host(acc, gyro, dts, BIAS)
    R0 = so3_exp(np.asarray([0.2, -0.1, 0.4]))
    t0 = np.asarray([1.0, -2.0, 0.5])
    v0 = np.asarray([0.3, 0.1, -0.2])
    ref = pim.predict(NavState(Pose(R0, t0), v0), bias_now)
    jc, tc = chunks(pim)
    args = (R0, t0, v0, bias_now, ImuParams().g_vec)
    got = tpd.predict(tc, *(torch.as_tensor(a, dtype=torch.float32) for a in args))
    jgot = jpd.predict(jc, *(jnp.asarray(a, jnp.float32) for a in args))
    for g, j, r in zip(got, jgot, (ref.pose.R, ref.pose.t, ref.vel)):
        np.testing.assert_allclose(g.numpy(), r, atol=2e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=2e-5)


def test_noise_information_matches_host_and_jax(rng):
    acc, gyro, dts = make_meas(rng, 50)
    pim = integrate_host(acc, gyro, dts, np.zeros(6))
    ref = pim.noise_information()
    jc, tc = chunks(pim)
    info = tpd.noise_information(tc.cov).numpy().astype(np.float64)
    jinfo = np.asarray(jpd.noise_information(jc.cov), np.float64)
    d = np.sqrt(np.abs(np.diagonal(ref)))
    scale = np.outer(d, d)
    np.testing.assert_allclose(info / scale, ref / scale, atol=2e-3)
    np.testing.assert_allclose(info / scale, jinfo / scale, atol=2e-3)
