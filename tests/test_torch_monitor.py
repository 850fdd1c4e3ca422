"""The keyframe monitor through the port on the CPU: ``tests/test_monitor.py``'s
three cases (``:12``, ``:50``, ``:65``) on the port, and the monitor-enabled
synthetic run of ``:50`` (``tests/test_slam_e2e.py``'s scene, keyframes fed
straight into the video, rollup 10/4, 14 frames, the oracle) through both
packages.

Held, port against JAX on that run: the recorded stamps and the file stems
exactly; positions within 1e-4 (``test_torch_stereo.py``'s pose bound on
this scene: f32 oracle and BA on both sides, sums in another order); the
attitude within 1e-2 degrees; the gyro bias (zero on the visual path)
exactly.  The JAX monitor converts ``matrix_to_ypr``'s degrees to degrees
once more (a fault of the reference, ROADMAP Queue 3); the port records
degrees, so the JAX attitude is held after dividing that factor out.
"""

import os

import numpy as np

from tests.test_slam_e2e import H8, W8, make_cfg, make_scene
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_stereo import PortHarness, port_cfg

INTR = np.asarray([16.0, 16.0, W8 / 2, H8 / 2], np.float32)
STEMS = ("monitor_", "disparity", "flow_weight", "covisible")


def test_monitor_unit_dumps(tmp_path):
    """tests/test_monitor.py:12 on the port: every dump method writes a PNG;
    a ground-truth lookup turns the attitude into an error series."""
    from dbaf_tpu_torch.eval.monitor import Monitor

    rng = np.random.default_rng(0)

    def gt(t):
        T = np.eye(4)
        T[:3, 3] = [t, 0.5 * t, 0.0]
        return T

    mon = Monitor(str(tmp_path), gt_lookup=gt)
    for k in range(6):
        T = np.eye(4)
        T[:3, 3] = [k, 0.5 * k + 0.01, 0.0]
        mon.record_keyframe(float(k), T, gyro_bias=[1e-4, -1e-4, 0.0])
    p = mon.dump_summary()
    assert os.path.exists(p) and os.path.getsize(p) > 0
    assert len(mon.pos_ref) == 6
    assert np.max(np.abs(np.asarray(mon.att))) < 1.0  # error, not attitude

    assert os.path.exists(mon.dump_disparity(rng.uniform(0, 1, (8, 16))))
    p = mon.dump_flow_weight(rng.integers(0, 255, (8, 16, 3)).astype(np.uint8),
                             rng.uniform(0, 10, (8, 16, 2)), rng.uniform(0, 10, (8, 16, 2)),
                             rng.uniform(0, 1, (8, 16, 2)))
    assert os.path.exists(p)
    p = mon.dump_covisible(rng.normal(size=(6, 3)), np.array([0, 1, 2]), np.array([3, 4, 5]),
                           np.array([0]), np.array([2]))
    assert os.path.exists(p)
    assert mon.dump_summary() != p  # the counters advance


def test_monitor_attitude_in_degrees(tmp_path):
    """A 30 degree yaw is recorded as 30 (the JAX monitor records 30 x 180/pi)."""
    from dbaf_tpu.eval.monitor import Monitor as JaxMonitor

    from dbaf_tpu_torch.eval.monitor import Monitor
    from dbaf_tpu_torch.utils.geodesy import ypr_to_matrix

    T = np.eye(4)
    T[:3, :3] = ypr_to_matrix(np.array([30.0, 0.0, 0.0]))
    port, jax_mon = Monitor(str(tmp_path)), JaxMonitor(str(tmp_path))
    port.record_keyframe(0.0, T)
    jax_mon.record_keyframe(0.0, T)
    np.testing.assert_allclose(port.att[0], [30.0, 0.0, 0.0], atol=1e-9)
    np.testing.assert_allclose(jax_mon.att[0], np.rad2deg([30.0, 0.0, 0.0]), atol=1e-9)


def _jax_run(n, cfg, gt_poses, gt_disps):
    from tests.test_slam_e2e import Harness

    h = Harness(cfg, gt_poses, gt_disps, INTR)
    for k in range(n):
        h.feed(k)
    return h


def _port_run(n, cfg, gt_poses, gt_disps):
    h = PortHarness(cfg, gt_poses, gt_disps)
    for k in range(n):
        h.feed(k)
    return h


def _stems(path):
    return sorted({f.rsplit("_", 1)[0] for f in os.listdir(path)})


def test_monitor_system_run_matches_jax(tmp_path):
    """tests/test_monitor.py:50 on the port (the summary and the debug views
    at each rollup), and the same run through the JAX package."""
    n = 14
    gt_poses, gt_disps = make_scene(n, INTR)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jc = make_cfg(rollup_start=10, rollup_shift=4, monitor_dir=str(jdir))
    j = _jax_run(n, jc, gt_poses, gt_disps)
    pc = port_cfg(jc)
    pc.frontend.monitor_dir = str(pdir)
    p = _port_run(n, pc, gt_poses, gt_disps)

    assert p.frontend.monitor is not None
    assert p.frontend.rollup_count >= 1
    files = os.listdir(pdir)
    for stem in STEMS:
        assert any(f.startswith(stem) for f in files), (stem, files)
    assert _stems(pdir) == _stems(jdir)
    assert p.frontend.rollup_count == j.frontend.rollup_count
    assert p.frontend.monitor.dumps == j.frontend.monitor.dumps

    pm, jm = p.frontend.monitor, j.frontend.monitor
    np.testing.assert_array_equal(pm.t, jm.t)
    np.testing.assert_allclose(np.asarray(pm.pos), np.asarray(jm.pos), atol=1e-4)
    np.testing.assert_allclose(np.asarray(pm.att), np.deg2rad(np.asarray(jm.att)), atol=1e-2)
    np.testing.assert_array_equal(np.asarray(pm.bg), np.asarray(jm.bg))
    # the monitor's rows are the trajectory's: one per keyframe step
    traj = p.frontend.trajectory
    assert len(pm.t) == len(traj)
    np.testing.assert_array_equal(pm.t, [t for t, _ in traj])


def test_visualize_animation_frames(tmp_path):
    """tests/test_monitor.py:65 on the port: the headless animation writes
    one PNG per ``stride`` keyframes with the chase camera."""
    from dbaf_tpu_torch.eval.visualize import animate_matplotlib

    rng = np.random.default_rng(0)
    cams, points = {}, {}
    for k in range(5):
        T = np.eye(4)
        T[:3, 3] = [0.3 * k, 0.0, 0.0]
        cams[k] = T
        points[k] = dict(pts=rng.normal(size=(50, 3)) + T[:3, 3], clr=rng.random((50, 3)))
    out = tmp_path / "anim"
    frames = animate_matplotlib({"cameras": cams, "points": points}, str(out), stride=2)
    assert len(frames) == 3
    for f in frames:
        assert (out / os.path.basename(f)).stat().st_size > 1000
