"""The port's host factor graph (numpy f64: ``fusion/se3np``,
``preintegration``, ``factors``, ``graph``, ``coupling``,
``utils/geodesy`` and ``slam/multisensor``) against the JAX package's.

The port keeps its own copies of these numpy-only modules, so the same
inputs must give the same f64 results: every comparison is held to 1e-12
(relative to the quantity's scale), and the accuracy checks of
``tests/test_fusion.py`` run on the port's copies as well.
"""

import importlib
import types

import numpy as np
import pytest

from tests.test_fusion import _GtsamCombinedOracle, _reorder_tvp_to_tpv, analytic_motion

TOL = dict(rtol=1e-12, atol=1e-12)


def _pkg(name: str) -> types.SimpleNamespace:
    m = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    ns = types.SimpleNamespace()
    for sub in ("fusion.se3np", "fusion.preintegration", "fusion.factors", "fusion.graph",
                "fusion.coupling", "utils.geodesy", "slam.multisensor"):
        vars(ns).update({k: v for k, v in vars(m(sub)).items() if not k.startswith("__")})
    ns.geodesy = m("utils.geodesy")
    return ns


JAXP, PORT = _pkg("dbaf_tpu"), _pkg("dbaf_tpu_torch")


def _samples(p, t0, t1, dt):
    """tests/test_fusion.py::simulate_imu in package namespace ``p``."""
    g = p.ImuParams().g_vec
    R = np.eye(3)
    ts = np.arange(t0, t1 + dt / 2, dt)
    Rs = [R]
    for k in range(len(ts) - 1):
        R = R @ p.so3_exp(analytic_motion(ts[k])[3] * dt)
        Rs.append(R)
    out = []
    for k in range(len(ts) - 1):
        _, _, a, w = analytic_motion(ts[k])
        out.append((Rs[k].T @ (a - g), w, dt))
    p0, v0, _, _ = analytic_motion(t0)
    p1, v1, _, _ = analytic_motion(t1)
    return out, p.NavState(p.Pose(Rs[0], p0), v0), p.NavState(p.Pose(Rs[-1], p1), v1)


def _pim(p, t0=0.0, t1=0.2, dt=1e-3, bias=None, **kw):
    samples, s0, s1 = _samples(p, t0, t1, dt)
    pim = p.PreintegratedImu(p.ImuParams(**kw), bias)
    for acc, w, d in samples:
        pim.integrate(acc, w, d)
    return pim, s0, s1


def test_preintegration_matches_jax():
    bias = np.array([0.05, -0.03, 0.02, 0.004, -0.003, 0.002])
    got, s0, _ = _pim(PORT, bias=bias, accel_noise=0.05, gyro_noise=0.005)
    ref, r0, _ = _pim(JAXP, bias=bias, accel_noise=0.05, gyro_noise=0.005)
    for name in ("dR", "dp", "dv", "cov", "dt"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name), **TOL, err_msg=name)
    b2 = bias + 1e-3
    for a, b in zip(got.corrected_deltas(b2), ref.corrected_deltas(b2)):
        np.testing.assert_allclose(a, b, **TOL)
    pg, pr = got.predict(s0, b2), ref.predict(r0, b2)
    np.testing.assert_allclose(pg.pose.matrix(), pr.pose.matrix(), **TOL)
    np.testing.assert_allclose(pg.vel, pr.vel, **TOL)
    np.testing.assert_allclose(got.noise_information(), ref.noise_information(), rtol=1e-12)


def test_preintegration_predicts_analytic_motion_on_the_port():
    """tests/test_fusion.py's first-order checks on the port's copy."""
    pim, s0, s1 = _pim(PORT, 0.0, 0.5, 1.0 / 2000.0)
    pred = pim.predict(s0, np.zeros(6))
    np.testing.assert_allclose(pred.pose.t, s1.pose.t, atol=2e-3)
    np.testing.assert_allclose(pred.vel, s1.vel, atol=2e-3)
    np.testing.assert_allclose(pred.pose.R, s1.pose.R, atol=2e-3)


def _values(p, rng):
    Ti = p.Pose.expmap(rng.normal(size=6) * 0.3)
    Tj = Ti.retract(rng.normal(size=6) * 0.2)
    vi = rng.normal(size=3)
    return p.Values({p.X(0): Ti, p.V(0): vi, p.X(1): Tj, p.V(1): vi + rng.normal(size=3) * 0.2,
                     p.B(0): rng.normal(size=6) * 0.01, p.B(1): rng.normal(size=6) * 0.01})


def _factor(p, which, rng):
    if which == "imu":
        return p.CombinedImuFactor(p.X(0), p.V(0), p.X(1), p.V(1), p.B(0), p.B(1), _pim(p)[0])
    if which == "gps":
        return p.GPSFactor(p.X(0), rng.normal(size=3), p.Noise.sigmas([1, 1, 5], cauchy_k=1.0))
    if which == "vel":
        return p.VelFactor(p.X(0), p.V(0), rng.normal(size=3), p.Noise.sigmas([2, 2, 2]))
    if which == "prior":
        return p.PriorPose(p.X(0), p.Pose.expmap(rng.normal(size=6) * 0.2),
                           p.Noise.sigmas([0.1] * 6))
    if which == "between":
        return p.BetweenVec(p.V(0), p.V(1), rng.normal(size=3), p.Noise.sigmas([0.5] * 3))
    H = rng.normal(size=(9, 9))
    lin = {p.X(0): p.Pose.expmap(rng.normal(size=6) * 0.1), p.V(0): rng.normal(size=3)}
    return p.LinearContainerFactor([p.X(0), p.V(0)], [6, 3], H @ H.T, rng.normal(size=9), lin)


@pytest.mark.parametrize("which", ["imu", "gps", "vel", "prior", "between", "container"])
def test_factor_linearization_matches_jax(which):
    out = []
    for p in (PORT, JAXP):
        rng = np.random.default_rng(7)
        vals = _values(p, rng)
        f = _factor(p, which, rng)
        out.append(p.FactorGraph([f]).linearize_to_hessian(vals))
    got, ref = out
    assert got.keys == ref.keys and got.dims == ref.dims
    for a, b in ((got.H, ref.H), (got.v, ref.v)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * max(np.abs(b).max(), 1.0))


def _lm_problem(p, rng):
    """tests/test_fusion.py::test_lm_imu_gps_fusion's graph."""
    n_kf, dt_kf = 6, 0.4
    graph, values, truth = p.FactorGraph(), p.Values(), []
    params = dict(accel_noise=0.05, gyro_noise=0.005)
    for k in range(n_kf):
        pim, s0, s1 = _pim(p, k * dt_kf, (k + 1) * dt_kf, 1e-3, **params)
        if k == 0:
            truth.append((s0.pose, s0.vel))
        truth.append((s1.pose, s1.vel))
        graph.add(p.CombinedImuFactor(p.X(k), p.V(k), p.X(k + 1), p.V(k + 1), p.B(k),
                                      p.B(k + 1), pim))
    for k in range(n_kf + 1):
        pose_gt, vel_gt = truth[k]
        graph.add(p.GPSFactor(p.X(k), pose_gt.t + rng.normal(size=3) * 0.01,
                              p.Noise.sigmas([0.05] * 3)))
        values[p.X(k)] = pose_gt.retract(rng.normal(size=6) * 0.1)
        values[p.V(k)] = vel_gt + rng.normal(size=3) * 0.3
        values[p.B(k)] = np.zeros(6)
    graph.add(p.PriorPose(p.X(0), truth[0][0], p.Noise.sigmas([0.01] * 6)))
    graph.add(p.PriorVec(p.B(0), np.zeros(6), p.Noise.sigmas([0.1] * 6)))
    return graph, values, truth


def test_levenberg_marquardt_matches_jax():
    res = []
    for p in (PORT, JAXP):
        graph, values, truth = _lm_problem(p, np.random.default_rng(11))
        res.append((graph, p.LevenbergMarquardt(graph, values).optimize(), truth))
    (g_p, r_p, truth), (g_j, r_j, _) = res
    assert set(r_p) == set(r_j)
    for key in r_p:
        a, b = r_p[key], r_j[key]
        if hasattr(a, "matrix"):
            a, b = a.matrix(), b.matrix()
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12, err_msg=key)
    np.testing.assert_allclose(g_p.error(r_p), g_j.error(r_j), rtol=1e-12)
    # tests/test_fusion.py's accuracy bounds, on the port
    assert g_p.error(r_p) < 100.0
    for k in range(len(truth)):
        assert np.linalg.norm(r_p[PORT.X(k)].t - truth[k][0].t) < 0.15
        assert np.linalg.norm(r_p[PORT.V(k)] - truth[k][1]) < 0.8


def test_marginalize_out_matches_jax():
    """A window of IMU + GPS factors with its first two frames
    marginalized: the marginal's information, vector and linearization
    point, and the reduced solve (tests/test_fusion.py's equivalence)."""
    out = []
    for p in (PORT, JAXP):
        graph, values, _ = _lm_problem(p, np.random.default_rng(5))
        removed = {p.X(0), p.V(0), p.B(0), p.X(1), p.V(1), p.B(1)}
        sub = p.FactorGraph([f for f in graph.factors if any(k in removed for k in f.keys)])
        marg = p.marginalize_out(sub, values, sorted(removed))
        out.append((marg, values))
    (mp, vp), (mj, vj) = out
    assert list(mp.keys) == list(mj.keys) and list(mp.dims) == list(mj.dims)
    np.testing.assert_allclose(mp.H, mj.H, rtol=1e-12, atol=1e-12 * np.abs(mj.H).max())
    np.testing.assert_allclose(mp.v, mj.v, rtol=1e-12, atol=1e-12 * np.abs(mj.v).max())
    for a, b in zip(mp.quadratic(vp), mj.quadratic(vj)):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12 * np.abs(mj.H).max())


def test_marginalize_out_equivalence_on_the_port():
    """tests/test_fusion.py::test_marginalize_out_equivalence on the port."""
    p = PORT
    rng = np.random.default_rng(0)
    n = 5
    graph = p.FactorGraph()
    values = p.Values({p.V(k): np.zeros(3) for k in range(n)})
    for k in range(n):
        graph.add(p.PriorVec(p.V(k), rng.normal(size=3), p.Noise.sigmas([1.0] * 3)))
    for k in range(n - 1):
        graph.add(p.BetweenVec(p.V(k), p.V(k + 1), rng.normal(size=3) * 0.1,
                               p.Noise.sigmas([0.5] * 3)))
    full = p.LevenbergMarquardt(graph, values).optimize()
    removed = {p.V(0), p.V(1)}
    sub = p.FactorGraph([f for f in graph.factors if any(k in removed for k in f.keys)])
    graph2 = p.FactorGraph([p.marginalize_out(sub, values, [p.V(0), p.V(1)])])
    for f in graph.factors:
        if all(k not in removed for k in f.keys):
            graph2.add(f)
    reduced = p.LevenbergMarquardt(
        graph2, p.Values({p.V(k): np.zeros(3) for k in range(2, n)})).optimize()
    for k in range(2, n):
        np.testing.assert_allclose(reduced[p.V(k)], full[p.V(k)], atol=1e-5)


@pytest.mark.parametrize("interval", [0.05, 0.1, 0.5])
def test_preintegration_covariance_matches_gtsam_combined_on_the_port(interval):
    """tests/test_fusion.py:283's GTSAM CombinedImuFactor covariance oracle,
    on the port's copy, and the JAX package's covariance, to 1e-12."""
    params = dict(accel_noise=0.05, gyro_noise=0.005, accel_walk=1e-4, gyro_walk=1e-6)
    bias = np.array([0.02, -0.01, 0.03, 0.002, -0.001, 0.0015])
    pims = [p.PreintegratedImu(p.ImuParams(**params), bias) for p in (PORT, JAXP)]
    orc = _GtsamCombinedOracle(JAXP.ImuParams(**params), bias)
    rng = np.random.default_rng(3)
    hz = 200.0
    for k in range(max(int(round(interval * hz)), 1)):
        t = k / hz
        acc = np.array([0.4 * np.sin(3 * t), 9.807 + 0.2 * np.cos(5 * t),
                        -0.3 * np.sin(2 * t)]) + 0.01 * rng.standard_normal(3)
        gyr = np.array([0.3 * np.cos(2 * t), -0.25 * np.sin(4 * t), 0.2]) + \
            0.002 * rng.standard_normal(3)
        for pim in pims:
            pim.integrate(acc, gyr, 1.0 / hz)
        orc.integrate(acc, gyr, 1.0 / hz)
    got = _reorder_tvp_to_tpv(pims[0].cov)
    scale = max(np.linalg.norm(orc.cov), 1e-30)
    assert np.linalg.norm(got - orc.cov) < 1e-12 * scale
    assert np.linalg.norm(pims[0].cov - pims[1].cov) < 1e-12 * scale


def test_coupling_matches_jax():
    rng = np.random.default_rng(2)
    H = rng.normal(size=(18, 18))
    H = H @ H.T
    v = rng.normal(size=18)
    dx = rng.normal(size=18)
    out = []
    for p in (PORT, JAXP):
        Tbc = p.Pose.expmap(np.array([0.1, -0.2, 0.05, 0.3, 0.1, -0.2]))
        Hb, vb = p.convert_hessian(H, v, Tbc)
        poses = {p.X(k): p.Pose.expmap(np.full(6, 0.05 * k)) for k in range(3)}
        f = p.hessian_factor([0, 1, 2], poses, Hb, vb)
        vals = p.Values({key: T.retract(np.full(6, 0.01)) for key, T in poses.items()})
        lf = p.FactorGraph([f]).linearize_to_hessian(vals)
        out.append((p.ba2fg_block(Tbc), Hb, vb, p.convert_dx(dx, Tbc), (lf.H, lf.v)))
    for a, b in zip(out[0][:4], out[1][:4]):
        np.testing.assert_allclose(a, b, **TOL)
    for a, b in zip(out[0][4], out[1][4]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * np.abs(b).max())


def test_geodesy_matches_jax():
    llh = np.array([np.deg2rad(30.5), np.deg2rad(114.3), 40.0])
    ypr = np.array([0.3, -0.1, 0.2])
    for name, arg in (("geodetic_to_ecef", llh), ("ypr_to_matrix", ypr),
                      ("att_to_matrix", ypr)):
        np.testing.assert_allclose(getattr(PORT.geodesy, name)(arg),
                                   getattr(JAXP.geodesy, name)(arg), **TOL)
    ecef = PORT.geodesy.geodetic_to_ecef(llh)
    np.testing.assert_allclose(PORT.geodesy.ecef_to_geodetic(ecef),
                               JAXP.geodesy.ecef_to_geodetic(ecef), rtol=1e-12)
    np.testing.assert_allclose(PORT.geodesy.ecef_to_geodetic(ecef), llh, rtol=1e-9, atol=1e-7)
    np.testing.assert_allclose(PORT.geodesy.Cen(ecef), JAXP.geodesy.Cen(ecef), **TOL)
    R = PORT.geodesy.ypr_to_matrix(ypr)
    np.testing.assert_allclose(PORT.geodesy.matrix_to_ypr(R), JAXP.geodesy.matrix_to_ypr(R),
                               **TOL)
    a, b = np.array([0.0, 0.0, 9.8]), np.array([0.3, -0.2, 9.7])
    np.testing.assert_allclose(PORT.geodesy.from_two_vectors(a, b),
                               JAXP.geodesy.from_two_vectors(a, b), **TOL)


def test_multisensor_state_matches_jax():
    """Stream IMU rows, image stamps, GNSS and odometry into both states,
    merge a keyframe and roll the window up: the same preintegrations,
    stamps and measurement rows."""
    states = [p.MultiSensorState() for p in (PORT, JAXP)]
    rng = np.random.default_rng(4)
    rows = [(k / 200.0, rng.normal(size=3) + [0, 0, 9.8], rng.normal(size=3) * 0.1)
            for k in range(200)]
    for st in states:
        st.set_imu_params([0.05, 0.005, 1e-4, 1e-6])
        st.init_first_state(0.0, np.zeros(3), np.eye(3), np.zeros(3))
        for k, (t, acc, gyr) in enumerate(rows):
            st.append_imu(t, acc, gyr)
            if k % 20 == 19:
                st.append_img(t)
                st.append_gnss(t, np.array([t, 2 * t, 0.0]))
                st.append_odo(t, np.array([1.0, 0.0, 0.0]))
        st.merge_keyframe(3)
        st.rollup(2)
    sp, sj = states
    assert len(sp) == len(sj)
    np.testing.assert_array_equal(sp.timestamps, sj.timestamps)
    for a, b in zip(sp.preintegrations, sj.preintegrations):
        for name in ("dR", "dp", "dv", "cov", "dt"):
            np.testing.assert_allclose(getattr(a, name), getattr(b, name), **TOL)
    for name in ("gnss_valid", "odo_valid"):
        assert list(getattr(sp, name)) == list(getattr(sj, name))
    for a, b in zip(sp.gnss_position + sp.odo_vel + sp.vs + sp.bs,
                    sj.gnss_position + sj.odo_vel + sj.vs + sj.bs):
        np.testing.assert_array_equal(a, b)
