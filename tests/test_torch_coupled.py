"""The port's tightly-coupled path end to end on the CPU, against the JAX
package, plus the entry-point and frontend unit cases of the coupled slice.

The end-to-end scenario is ``test_slam_multisensor.py``'s (8x16 feature
grid, 26 frames at 10 fps, 200 Hz IMU, oracle update operator, VI init at
the 12-keyframe warmup) with the device factor-graph solver and the fused
coupled step on and the asynchronous pipeline off.  Both packages run it in
this process; the JAX side is shared through a module-scoped fixture.

Tolerances.  The keyframe stamps, the VI-initialization keyframe and the
fused-step count must be identical (the cull decisions are the same).  Up to
the frame before VI initialization (the visual path) the keyframe poses
agree to ``atol 1e-3``, the visual trace's tolerance of
``test_torch_system.py`` (measured 9e-5).  After it the body positions agree
to ``atol 3e-2`` m and the biases to ``1e-4``, ten times the measured 9.6e-6.
The position bound is set by the reference itself, not by the port: the VI
alignment and the coupled solve amplify f32 round-off, so the JAX package
moves its own positions by 1.19e-2 m when the oracle's disparities are
perturbed by 1e-6 (relative; ``test_torch_coupled_noise.py`` holds that
reading), and the port's positions move by 1.6e-2 m between 1 and 4 CPU
threads.  Against JAX the port measured 1.44e-2 m with one thread, as the
tests here run it (6e-3 m at 2 to 8 threads), span 2.3 m.  The JAX test's
own accuracy asserts (SE3-aligned ATE under 8% of the span, every |bias|
under 0.2, plane disparity within 0.8-1.25 of truth) must hold on the port,
and on its host f64 solver (``device_solver=False``) too; that case, which
needs no JAX run, is in ``test_torch_coupled_host_solver.py``.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_slam_e2e import H8, W8, make_cfg, plane_disparity
from tests.test_slam_multisensor import FPS, MsHarness, simulate

N_FRAMES = 26
INTR = np.asarray([16.0, 16.0, W8 / 2, H8 / 2], dtype=np.float32)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's eager solve is thousands of small ops: one intra-op thread
    runs them as fast, and keeps parallel test workers from oversubscribing
    the cores (spinning OpenMP threads slow every worker many times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene():
    from dbaf_tpu_torch.ops import lie_np

    imu_rows, poses_at = simulate(N_FRAMES / FPS + 0.5)
    gt_cw, gt_disps = [], []
    for k in range(N_FRAMES + 1):
        R, p = poses_at[k]
        Twc = np.eye(4)
        Twc[:3, :3], Twc[:3, 3] = R, p
        pose7 = lie_np.se3_from_matrix(np.linalg.inv(Twc)).astype(np.float32)
        gt_cw.append(pose7)
        gt_disps.append(plane_disparity(pose7, INTR, z0=4.0))
    return imu_rows, poses_at, np.stack(gt_cw), np.stack(gt_disps)


def _cfg(m, device_solver=True):
    """make_cfg's configuration in package ``m`` (the port's config module
    takes the same fields)."""
    jc = make_cfg(vi_warmup=12, keyframe_thresh=-1.0, rollup_start=1000)
    cfg = m.DBAFusionConfig(
        image_size=jc.image_size, buffer=jc.buffer,
        graph=m.GraphConfig(**vars(jc.graph)), frontend=m.FrontendConfig(**vars(jc.frontend)),
        ba=m.BAConfig(**vars(jc.ba)), sensors=m.SensorConfig(**vars(jc.sensors)))
    cfg.sensors.device_solver = device_solver
    cfg.sensors.coupled_async = False
    return cfg


class PortHarness:
    """MsHarness for the port: keyframes fed straight into the video, the
    oracle's frame identity through ``graph.aux['id_map']``."""

    def __init__(self, cfg, gt_cw, gt_disps, imu_rows):
        from dbaf_tpu_torch.eval.synthetic import make_oracle
        from dbaf_tpu_torch.fusion.se3np import Pose
        from dbaf_tpu_torch.slam.coupled import MultiSensorBA
        from dbaf_tpu_torch.slam.frontend import Frontend
        from dbaf_tpu_torch.slam.graph import CovisibleGraph
        from dbaf_tpu_torch.slam.video import DepthVideo

        dev = torch.device("cpu")
        self.video = DepthVideo(cfg, dev)
        self.id_map = np.zeros(cfg.buffer, dtype=np.int64)
        self.graph = CovisibleGraph(self.video, make_oracle(gt_cw, gt_disps, INTR), cfg)
        coupled = MultiSensorBA(self.video, cfg)
        coupled.Tbc = Pose()
        coupled.state.set_imu_params([0.05, 0.005, 1e-4, 1e-6])
        self.graph.coupled = coupled
        self.frontend = Frontend(self.video, self.graph, cfg)
        self.frontend.set_multisensor(imu_rows, visual_only=False)
        self.intr8 = torch.as_tensor(INTR)
        self.zeros = torch.zeros((H8, W8, 128), dtype=torch.bfloat16)

    def feed(self, k: int):
        idx = self.video.counter
        self.video.append(k / FPS, None, None, None, self.intr8, self.zeros, self.zeros,
                          self.zeros)
        self.id_map[idx] = k
        self.graph.aux = {"id_map": torch.as_tensor(self.id_map)}
        self.frontend()
        n = self.video.counter
        self.id_map[:n] = np.round(self.video.tstamp[:n] * FPS).astype(np.int64)


def _poses_np(video):
    p = video.poses[:video.counter]
    return p.numpy().copy() if isinstance(p, torch.Tensor) else np.asarray(p).copy()


def _summary(h, poses_at, vi_key, pre_vi):
    t1 = h.frontend.t1
    state = h.graph.coupled.state
    stamps = np.asarray(h.video.tstamp[:t1])
    gt_ids = np.round(stamps * FPS).astype(int)
    disps = h.video.disps[t1 - 2]
    return dict(
        t1=t1, stamps=stamps, vi_key=vi_key, megas=h.graph.mega_count,
        imu=h.video.imu_enabled,
        est=np.asarray([state.wTbs[k].t for k in range(t1)]),
        bs=np.asarray([state.bs[k] for k in range(t1)]),
        ref=np.stack([poses_at[g][1] for g in gt_ids]), pre_vi=pre_vi,
        disp=np.asarray(disps.numpy() if isinstance(disps, torch.Tensor) else disps))


def _run(h, poses_at):
    vi_key = pre_vi = None
    for k in range(N_FRAMES):
        h.feed(k)
        if vi_key is None and h.video.imu_enabled:
            vi_key = k
        if vi_key is None:
            pre_vi = _poses_np(h.video)  # the keyframe poses before VI init
    return _summary(h, poses_at, vi_key, pre_vi)


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def jax_run(scene):
    from dbaf_tpu.utils import config as jconfig

    imu_rows, poses_at, gt_cw, gt_disps = scene
    h = MsHarness(_cfg(jconfig), jnp.asarray(gt_cw), jnp.asarray(gt_disps), INTR, imu_rows)
    return _run(h, poses_at)


def _port_run(scene, device_solver):
    from dbaf_tpu_torch.utils import config as tconfig

    imu_rows, poses_at, gt_cw, gt_disps = scene
    h = PortHarness(_cfg(tconfig, device_solver), gt_cw, gt_disps, imu_rows)
    return _run(h, poses_at)


def _accuracy_asserts(s, gt_disps):
    """test_slam_multisensor.py:122-143 on a run summary."""
    from dbaf_tpu_torch.eval.ate import ate_rmse

    assert s["imu"], "VI initialization did not trigger"
    rmse = ate_rmse(s["est"], s["ref"], align="se3")
    span = np.linalg.norm(s["ref"].max(0) - s["ref"].min(0))
    assert rmse < 0.08 * span, (rmse, span)
    assert np.all(np.abs(s["bs"]) < 0.2), s["bs"].max()
    gt_ids = np.round(s["stamps"] * FPS).astype(int)
    ratio = np.median(s["disp"] / gt_disps[gt_ids[s["t1"] - 2]])
    assert 0.8 < ratio < 1.25, ratio


def test_coupled_e2e_matches_jax(scene, jax_run):
    got = _port_run(scene, device_solver=True)
    ref = jax_run
    assert got["vi_key"] == ref["vi_key"] and got["vi_key"] is not None
    assert got["t1"] == ref["t1"]
    np.testing.assert_array_equal(got["stamps"], ref["stamps"])  # identical keyframes
    assert got["megas"] == ref["megas"] and got["megas"] >= 10
    np.testing.assert_allclose(got["pre_vi"], ref["pre_vi"], atol=1e-3)
    np.testing.assert_allclose(got["est"], ref["est"], atol=3e-2)
    np.testing.assert_allclose(got["bs"], ref["bs"], atol=1e-4)
    _accuracy_asserts(ref, scene[3])
    _accuracy_asserts(got, scene[3])


def _frontends(cfg_kw=None):
    """A JAX and a port Frontend on the same config, over a stand-in graph
    that holds only the MultiSensorBA (the ZUPT and ECEF-row cases)."""
    from dbaf_tpu.slam.coupled import MultiSensorBA as JBA
    from dbaf_tpu.slam.frontend import Frontend as JFrontend
    from dbaf_tpu.slam.video import DepthVideo as JVideo
    from dbaf_tpu.utils import config as jconfig
    from dbaf_tpu_torch.slam.coupled import MultiSensorBA as TBA
    from dbaf_tpu_torch.slam.frontend import Frontend as TFrontend
    from dbaf_tpu_torch.slam.video import DepthVideo as TVideo
    from dbaf_tpu_torch.utils import config as tconfig

    out = []
    for m, Video, BA, Fe, dev in ((jconfig, JVideo, JBA, JFrontend, ()),
                                  (tconfig, TVideo, TBA, TFrontend, ("cpu",))):
        cfg = _cfg(m)
        for k, v in (cfg_kw or {}).items():
            setattr(cfg.sensors, k, v)
        video = Video(cfg, *dev)
        graph = types.SimpleNamespace(coupled=BA(video, cfg))
        out.append(Fe(video, graph, cfg))
    return out


def test_zupt_gate_unit_matches_jax():
    """test_zupt.py:232's cases on both frontends: the gate fires iff
    use_zupt AND the merged interval below the window top spans > 3 s AND
    |v| of the second-newest keyframe < 0.025 m/s."""
    from dbaf_tpu.fusion.preintegration import ImuParams as JParams
    from dbaf_tpu.fusion.preintegration import PreintegratedImu as JPim
    from dbaf_tpu_torch.fusion.preintegration import ImuParams as TParams
    from dbaf_tpu_torch.fusion.preintegration import PreintegratedImu as TPim

    fes = _frontends({"use_zupt": True})
    mods = ((JParams, JPim), (TParams, TPim))

    def setup(fe, mod, dt_merged, v_norm):
        Params, Pim = mod
        st = fe.coupled.state

        def pim(dt):
            p = Pim(Params(), np.zeros(6))
            p.integrate(np.array([0.0, 0.0, 9.807]), np.zeros(3), dt)
            return p

        fe.t1 = 5
        st.cur_t = 1.0
        st.preintegrations = [pim(0.1), pim(0.1), pim(dt_merged), pim(0.1), pim(0.1)]
        st.vs = [np.zeros(3)] * 6
        st.vs[3] = np.array([v_norm, 0.0, 0.0])  # t1-2 slot
        st.odo_valid = [False] * 6
        st.odo_vel = [np.zeros(3)] * 6
        return st

    for case, expect in (((3.5, 0.01), True), ((2.9, 0.01), False), ((3.5, 0.03), False)):
        got = []
        for fe, mod in zip(fes, mods):
            st = setup(fe, mod, *case)
            got.append((fe._zupt_gate(1.0), st.odo_valid[-1]))
            if expect:
                np.testing.assert_array_equal(st.odo_vel[-1], np.zeros(3))
        assert got[0] == got[1] == (expect, expect), (case, got)
    for fe, mod in zip(fes, mods):  # flag off
        st = setup(fe, mod, 3.5, 0.01)
        fe.use_zupt = False
        assert not fe._zupt_gate(1.0) and not st.odo_valid[-1]


def test_traj_rows_gain_ecef_after_gnss_init_matches_jax():
    """test_slam_multisensor.py:340's case on both frontends: once
    georeferenced, every trajectory row gets a f64 ECEF position
    ``ten0 + Cen(ten0) @ p``, to rtol 1e-12 of the JAX package's."""
    from dbaf_tpu_torch.fusion.se3np import Pose, so3_exp
    from dbaf_tpu_torch.utils import geodesy

    fes = _frontends()
    T = Pose(so3_exp(np.array([0.1, -0.2, 0.3])), np.array([1.0, 2.0, 3.0]))
    ten0 = geodesy.geodetic_to_ecef(np.array([np.deg2rad(30.5), np.deg2rad(114.3), 40.0]))
    for fe in fes:
        fe._write_traj_row(0.5, T)
        assert fe.trajectory_ecef == {}  # not georeferenced yet
        fe.coupled.ten0 = np.asarray(ten0, float)
        fe.coupled.gnss_init_t1 = 5
        fe._write_traj_row(0.6, T)
        assert set(fe.trajectory_ecef) == {1}
    jfe, tfe = fes
    expect = ten0 + geodesy.Cen(ten0) @ T.t
    np.testing.assert_allclose(tfe.trajectory_ecef[1], jfe.trajectory_ecef[1], rtol=1e-12)
    np.testing.assert_allclose(tfe.trajectory_ecef[1], expect, rtol=1e-12)
    back = geodesy.Cen(ten0).T @ (tfe.trajectory_ecef[1] - ten0)
    np.testing.assert_allclose(back, T.t, atol=1e-8)
    for (tj, rj), (tt, rt) in zip(jfe.trajectory, tfe.trajectory):
        assert tj == tt
        np.testing.assert_allclose(rt[:3], rj[:3], atol=1e-6)
        # the same rotation: quaternions agree up to sign
        assert abs(abs(float(np.dot(rt[3:], rj[3:]))) - 1.0) < 1e-6
