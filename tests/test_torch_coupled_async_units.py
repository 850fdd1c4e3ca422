"""Unit cases of the asynchronous coupled step's helpers
(``dbaf_tpu_torch/slam/coupled_async.py``) against the JAX package's
(``dbaf_tpu/slam/coupled_async.py``) on the same seeded numpy inputs:
``_predict_row`` (also against the host preintegration, as
``test_coupled_async.py``), ``_roll_pg``, ``_pg_merge_slot``,
``_pg_cull_frame_rows``, ``_relink_culled_gnss_odo`` and ``_inv15``.

Index moves are exact.  The f32 algebra is held at 2e-5 (the prediction, as
the JAX test holds it against the host), 1e-5 of each field's scale (the
chunk composition), 2e-3 Jacobi-scaled (a 15x15 inverse spanning ~10
decades, the JAX test's bound for the information matrix) and 1e-5 of the
marginal's scale (the re-linked GNSS/odometry factors).
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbaf_tpu.fusion import device_graph as jdg
from dbaf_tpu.fusion.preintegration import ImuParams, NavState, PreintegratedImu
from dbaf_tpu.fusion.se3np import Pose, so3_exp
from dbaf_tpu.slam import coupled_async as jca
from dbaf_tpu_torch.fusion import device_graph as tdg
from dbaf_tpu_torch.slam import coupled_async as tca
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)

NW = 8
T = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
J = lambda a: jnp.asarray(np.asarray(a))  # noqa: E731


def _pim(rng, n=40, bias=None):
    params = ImuParams(accel_noise=0.05, gyro_noise=0.005)
    pim = PreintegratedImu(params, np.zeros(6) if bias is None else bias)
    for k in range(n):
        t = k / 200.0
        acc = np.array([0.3 * np.sin(3 * t), 9.807 + 0.1 * t, -0.2]) + rng.normal(size=3) * 0.2
        gyr = np.array([0.2, -0.1 * np.cos(2 * t), 0.15]) + rng.normal(size=3) * 0.1
        pim.integrate(acc, gyr, 1 / 200.0)
    return pim


def _graphs(rng):
    """One packed graph (NW slots, real preintegrations in every IMU slot,
    some GNSS/odometry rows and priors) in both packages."""
    arrs = {}
    for name, shape, kind in jdg._graph_spec(NW, 4, 4):
        size = (int(np.prod(shape)),)
        if kind == "b":
            arrs[name] = (rng.random(size) < 0.6).astype(np.float32)
        elif kind == "i":
            arrs[name] = rng.integers(0, NW, size).astype(np.float32)
        else:
            arrs[name] = rng.normal(size=size).astype(np.float32)
        arrs[name] = arrs[name].reshape(shape)
    for k in range(NW - 1):
        pim = _pim(rng, bias=rng.normal(size=6) * 1e-3)
        for f in ("dR", "dv", "dp", "dt", "dRg", "dvg", "dva", "dpg", "dpa"):
            arrs["imu_" + f][k] = getattr(pim, f)
        arrs["imu_bias0"][k] = pim.bias
        arrs["imu_info"][k] = pim.noise_information()
    arrs["imu_mask"][:] = 1.0
    arrs["g_vec"] = ImuParams().g_vec.astype(np.float32)
    arrs["gnss_info"] = np.diag([1.0, 1.0, 0.04]).astype(np.float32)
    arrs["gnss_k2"] = np.asarray(0.08 ** 2, np.float32)
    arrs["odo_info"] = np.eye(3, dtype=np.float32) * 0.25
    flat = jdg.flatten_graph_np(arrs, NW)
    np.testing.assert_array_equal(flat, tdg.flatten_graph_np(arrs, NW))  # one layout
    return jdg.unflatten_graph(jnp.asarray(flat), NW), tdg.unflatten_graph(T(flat), NW)


def _assert_graph(tg, jg, atol=0.0, fields=None):
    for name in fields or tdg.PackedGraph._fields:
        a, b = np.asarray(getattr(tg, name)), np.asarray(getattr(jg, name))
        if atol:
            scale = max(np.abs(b).max(), 1e-3)
            np.testing.assert_allclose(a, b, atol=atol * scale, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)


@pytest.mark.parametrize("n_imu", [40, 210])
def test_predict_row_matches_host_and_jax(n_imu):
    """Over an interval of more than 1 s (210 samples at 200 Hz) the host
    carries the state (``MultiSensorState.append_img``), and so does the
    port's step; the JAX step propagates it (ROADMAP Queue 3)."""
    rng = np.random.default_rng(0)
    bias_int = np.array([0.01, -0.02, 0.015, 0.001, -0.002, 0.0005])
    pim = _pim(rng, n=n_imu, bias=bias_int)
    R0 = so3_exp(np.array([0.2, -0.1, 0.3]))
    p0, v0 = np.array([1.0, -2.0, 0.5]), np.array([0.3, 0.1, -0.2])
    bias_now = bias_int + np.array([2e-3, -1e-3, 5e-4, 1e-4, -2e-4, 3e-4])
    prev = NavState(Pose(R0, p0), v0)
    out = prev if pim.dt > 1.0 else pim.predict(prev, bias_now)
    jg, tg = _graphs(rng)
    k = 3
    fields = dict(imu_dR=pim.dR, imu_dv=pim.dv, imu_dp=pim.dp, imu_dt=pim.dt, imu_dRg=pim.dRg,
                  imu_dvg=pim.dvg, imu_dva=pim.dva, imu_dpg=pim.dpg, imu_dpa=pim.dpa,
                  imu_bias0=pim.bias)
    jg = jg._replace(**{n: getattr(jg, n).at[k].set(jnp.asarray(v, jnp.float32))
                        for n, v in fields.items()})
    tg = tg._replace(**{n: _with(getattr(tg, n), k, v) for n, v in fields.items()})
    row_prev = np.concatenate([R0.reshape(9), p0, v0, bias_now]).astype(np.float32)
    for kk in (k, torch.tensor(k)):  # a host or a device slot index
        row = tca._predict_row(T(row_prev), tg, kk, tg.g_vec).numpy()
        np.testing.assert_allclose(row[:9].reshape(3, 3), out.pose.R, atol=2e-5)
        np.testing.assert_allclose(row[9:12], out.pose.t, atol=2e-5)
        np.testing.assert_allclose(row[12:15], out.vel, atol=2e-5)
        np.testing.assert_allclose(row[15:21], bias_now, atol=1e-7)
    jrow = np.asarray(jca._predict_row(J(row_prev), jg, jnp.asarray(k), jg.g_vec))
    if pim.dt > 1.0:
        np.testing.assert_array_equal(row, row_prev)
        # the JAX step moves the state by metres where the host keeps it
        assert np.abs(jrow[9:12] - row_prev[9:12]).max() > 1.0, jrow[9:12]
        return
    np.testing.assert_allclose(row, jrow, atol=2e-5)


def _with(t, k, v):
    t = t.clone()
    t[k] = torch.as_tensor(np.asarray(v), dtype=t.dtype)
    return t


@pytest.mark.parametrize("shift", [0, 1, 3])
def test_roll_pg_matches_jax(shift):
    rng = np.random.default_rng(10 + shift)
    jg, tg = _graphs(rng)
    got = tca._roll_pg(tg, torch.tensor(shift), NW)
    _assert_graph(got, jca._roll_pg(jg, jnp.asarray(shift), NW))
    np.testing.assert_array_equal(got.imu_dv[0].numpy(), tg.imu_dv[shift].numpy())


def test_pg_cull_frame_rows_matches_jax():
    rng = np.random.default_rng(20)
    jg, tg = _graphs(rng)
    for rc in (0, 3, NW - 1):
        got = tca._pg_cull_frame_rows(tg, torch.tensor(rc), NW)
        _assert_graph(got, jca._pg_cull_frame_rows(jg, jnp.asarray(rc), NW))
        assert not bool(got.gnss_mask[-1]) and not bool(got.odo_mask[-1])  # the top slot dies


def test_pg_merge_slot_matches_jax():
    rng = np.random.default_rng(30)
    jg, tg = _graphs(rng)
    for s in (0, 2, NW - 3):
        got = tca._pg_merge_slot(tg, torch.tensor(s), NW)
        ref = jca._pg_merge_slot(jg, jnp.asarray(s), NW)
        index_fields = [n for n in tdg.PackedGraph._fields
                        if not n.startswith("imu_") or n == "imu_mask"]
        _assert_graph(got, ref, fields=index_fields)
        _assert_graph(got, ref, atol=1e-5, fields=[
            n for n in tdg.PackedGraph._fields
            if n.startswith("imu_") and n not in ("imu_mask", "imu_info")])
        _assert_info(got.imu_info.numpy(), np.asarray(ref.imu_info))


def _assert_info(a, b):
    """15x15 information blocks compared Jacobi-scaled."""
    for x, y in zip(a.reshape(-1, 15, 15), b.reshape(-1, 15, 15)):
        d = np.sqrt(np.abs(np.diagonal(y))) + 1e-30
        np.testing.assert_allclose(x / np.outer(d, d), y / np.outer(d, d), atol=2e-3)


def test_inv15_matches_jax():
    rng = np.random.default_rng(40)
    for _ in range(3):
        cov = _pim(rng).cov + np.eye(15) * 1e-12
        got = tca._inv15(T(cov.astype(np.float32))).numpy()
        ref = np.asarray(jca._inv15(J(cov.astype(np.float32))))
        _assert_info(got, ref)
        _assert_info(got, np.linalg.inv(cov))


@pytest.mark.parametrize("seed", range(3))
def test_relink_culled_gnss_odo_matches_jax(seed):
    rng = np.random.default_rng(50 + seed)
    jg, tg = _graphs(rng)
    rows = np.concatenate([
        np.stack([so3_exp(rng.normal(size=3) * 0.3).reshape(9) for _ in range(NW)]),
        rng.normal(size=(NW, 3)), rng.normal(size=(NW, 3)) * 0.5, rng.normal(size=(NW, 6)) * 1e-3,
    ], axis=1).astype(np.float32)
    N = NW * 15
    X = rng.normal(size=(N, N))
    H = (X @ X.T / N).astype(np.float32)
    mask = rng.random(NW) < 0.5
    lin = rows + rng.normal(size=rows.shape).astype(np.float32) * 1e-3
    v = rng.normal(size=N).astype(np.float32)
    c, o_prev, h0 = 5 + seed % 2, 1, seed % 2
    jm = jca._relink_culled_gnss_odo(jg, J(rows), jdg.MargDense(J(mask), J(lin), J(H), J(v)),
                                     jnp.asarray(c), jnp.asarray(o_prev), jnp.asarray(h0), NW)
    tm = tca._relink_culled_gnss_odo(tg, T(rows), tdg.MargDense(T(mask), T(lin), T(H), T(v)),
                                     torch.tensor(c), torch.tensor(o_prev), torch.tensor(h0), NW)
    np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask))
    np.testing.assert_allclose(tm.lin.numpy(), np.asarray(jm.lin), atol=1e-6)
    for a, b in ((tm.H, jm.H), (tm.v, jm.v)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5 * np.abs(b).max())
    if bool(tg.gnss_mask[c - h0]) or bool(tg.odo_mask[c - h0]):  # a factor was re-linked
        assert not np.array_equal(tm.H.numpy(), H)


def test_default_sensor_config_runs_the_host_solver_in_both_packages():
    """The JAX package's default SensorConfig (device_solver off,
    coupled_async on) runs the host f64 solve: its pipeline activates only
    with the device solver and the fused step.  Both packages run the
    26-frame scenario of test_torch_coupled.py that way, with the same
    keyframes, no fused step and no async step, positions within 3e-2 m and
    biases within 1e-4 of each other (the bounds of the device-solver
    comparison there), each within the JAX test's accuracy bounds."""
    from dbaf_tpu.utils import config as jconfig
    from dbaf_tpu_torch.slam.system import DBAFusion
    from dbaf_tpu_torch.utils import config as tconfig
    from tests.test_slam_multisensor import MsHarness
    from tests.test_torch_coupled import (INTR, PortHarness, _accuracy_asserts, _cfg, _run,
                                          _scene)

    assert not jconfig.SensorConfig().device_solver and jconfig.SensorConfig().coupled_async
    assert not tconfig.SensorConfig().device_solver and tconfig.SensorConfig().coupled_async
    imu_rows, poses_at, gt_cw, gt_disps = _scene()

    def run(m):
        cfg = _cfg(m, device_solver=False)
        cfg.sensors.coupled_async = True
        if m is jconfig:
            h = MsHarness(cfg, jnp.asarray(gt_cw), jnp.asarray(gt_disps), INTR, imu_rows)
        else:
            h = PortHarness(cfg, gt_cw, gt_disps, imu_rows)
        out = _run(h, poses_at)
        ca = h.frontend._casync
        assert ca is None or ca.total_steps == 0
        return out

    # the JAX run in a second thread: on the host solver most of either
    # run's time is compiling or numpy, both outside the interpreter lock
    with ThreadPoolExecutor(max_workers=1) as ex:
        jax_run = ex.submit(run, jconfig)
        got = run(tconfig)
        ref = jax_run.result()
    assert got["vi_key"] == ref["vi_key"] is not None
    np.testing.assert_array_equal(got["stamps"], ref["stamps"])
    assert got["megas"] == ref["megas"] == 0
    np.testing.assert_allclose(got["est"], ref["est"], atol=3e-2)
    np.testing.assert_allclose(got["bs"], ref["bs"], atol=1e-4)
    _accuracy_asserts(ref, gt_disps)
    _accuracy_asserts(got, gt_disps)

    # the entry point takes the configuration (it raised before the pipeline
    # was ported) and wires the coupled solve
    system = DBAFusion(_cfg(tconfig, device_solver=False), device="cpu", feat_fn=lambda x: x,
                       ctx_fn=lambda x: x, update_fn=lambda *a: a)
    system.cfg.sensors.coupled_async = True
    coupled = system.set_multisensor(np.zeros((4, 7)), np.eye(4),
                                     imu_noise=[0.05, 0.005, 1e-4, 1e-6])
    assert system.graph.coupled is coupled
    assert (system.frontend.iters1, system.frontend.iters2) == (2, 1)
    assert coupled.state.params.accel_noise == 0.05
