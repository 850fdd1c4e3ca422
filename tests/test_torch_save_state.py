"""save_state / load_state of the port on the CPU.

``tests/test_slam_e2e.py::test_save_load_state_roundtrip`` (``:230-272``)
runs on the port as it runs on the JAX package: 12 keyframes fed straight
into the video with the oracle, the state saved through the facade, four
more keyframes; then a fresh system loads the file and takes the same four.
Its bounds: the poses after the load within 1e-6 of the saved ones (they are
the same f32 values), the resumed run's within 1e-4 of the uninterrupted
run's.  The same round trip goes through ``DBAFusion(device="cpu")`` with
the asynchronous visual pipeline active at the save (``save_state`` drains
it first) and through the coupled path after VI initialization (the solve
is pickled without its device caches and rebuilds them from the host
state).  Every file holds numpy arrays and no torch tensor.
"""

import pickle

import numpy as np
import torch

from tests.test_slam_e2e import make_cfg, make_scene
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_stereo import INTR, PortHarness, port_cfg


def _facade(video, graph, frontend):
    """The port's DBAFusion around a harness's parts (as the JAX test does)."""
    from dbaf_tpu_torch.slam.system import DBAFusion

    sysm = DBAFusion.__new__(DBAFusion)
    sysm.video, sysm.graph, sysm.frontend = video, graph, frontend
    sysm.filter = sysm._async = None
    return sysm


def _tensors_in(obj, seen=None) -> int:
    """torch tensors reachable from ``obj`` (containers and attributes)."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return 0
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return 1
    if isinstance(obj, dict):
        return sum(_tensors_in(v, seen) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_tensors_in(v, seen) for v in obj)
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        return _tensors_in(vars(obj), seen)
    return 0


def _load_file(path):
    with open(path, "rb") as f:
        state = pickle.load(f)
    assert _tensors_in(state) == 0
    return state


def test_save_load_state_roundtrip(tmp_path):
    cfg = port_cfg(make_cfg())
    gt_poses, gt_disps = make_scene(16, INTR)
    h = PortHarness(cfg, gt_poses, gt_disps)
    for k in range(12):
        h.feed(k)
    path = str(tmp_path / "state.pkl")
    _facade(h.video, h.graph, h.frontend).save_state(path)
    state = _load_file(path)
    assert state["video"]["poses"].dtype == np.float32
    assert state["video"]["fmaps"].dtype == np.int16  # bf16 bit patterns

    poses_before = h.video.poses[:h.frontend.t1].numpy().copy()
    for k in range(12, 16):
        h.feed(k)
    poses_after_a = h.video.poses[:h.frontend.t1].numpy().copy()

    h2 = PortHarness(cfg, gt_poses, gt_disps)
    _facade(h2.video, h2.graph, h2.frontend).load_state(path)
    np.testing.assert_allclose(h2.video.poses[:h2.frontend.t1].numpy(), poses_before, atol=1e-6)
    n = h2.video.counter
    h2.id_map[:n] = np.round(h2.video.tstamp[:n]).astype(np.int64)
    for k in range(12, 16):
        h2.feed(k)
    poses_after_b = h2.video.poses[:h2.frontend.t1].numpy()
    np.testing.assert_allclose(poses_after_b, poses_after_a, atol=1e-4)


def _pipeline_system():
    from dbaf_tpu_torch.slam.system import DBAFusion
    from tests.test_async_pipeline import make_scene as scene
    from tests.test_torch_async_pipeline import port_cfg as pipe_cfg, port_fns

    gt_poses, gt_disps = scene(16, INTR)
    cfg = pipe_cfg(True)
    fns = port_fns(gt_poses, gt_disps, cfg.buffer)
    return DBAFusion(cfg, device="cpu", feat_fn=fns[0], ctx_fn=fns[1], update_fn=fns[2])


def test_save_state_drains_the_pipeline_and_resumes(tmp_path):
    """DBAFusion(device="cpu") with the asynchronous visual pipeline active
    at frame 12: save, run on to 16; a fresh system loads the file and runs
    12-16.  Bounds of the JAX test (1e-6 after the load, 1e-4 after the
    resumed run), and the trajectories' rows alike."""
    from tests.test_torch_async_pipeline import INTR_FULL, frames

    imgs = frames(16)
    a = _pipeline_system()
    for k in range(12):
        a.track(float(k), imgs[k], intrinsics=INTR_FULL)
    assert a._async.active
    path = str(tmp_path / "state.pkl")
    a.save_state(path)
    _load_file(path)
    assert not a._async.active  # drained for the snapshot
    poses_before = a.video.poses[:a.frontend.t1].numpy().copy()
    for k in range(12, 16):
        a.track(float(k), imgs[k], intrinsics=INTR_FULL)
    b = _pipeline_system()
    b.load_state(path)
    np.testing.assert_allclose(b.video.poses[:b.frontend.t1].numpy(), poses_before, atol=1e-6)
    for k in range(12, 16):
        b.track(float(k), imgs[k], intrinsics=INTR_FULL)
    assert a._async.active and b._async.active
    ta, tb = a.terminate(), b.terminate()
    assert a.frontend.t1 == b.frontend.t1 == 16
    np.testing.assert_allclose(b.video.poses[:16].numpy(), a.video.poses[:16].numpy(), atol=1e-4)
    np.testing.assert_array_equal(tb[:, 0], ta[:, 0])
    np.testing.assert_allclose(tb[:, 1:], ta[:, 1:], atol=1e-4)


def test_reference_load_state_leaves_the_gate_without_a_keyframe(tmp_path):
    """The JAX package's file has no motion-gate keyframe features
    (dbaf_tpu/slam/system.py:167-254): a system that loads it raises on its
    next track (a reference fault, ROADMAP Queue 3); the port's load_state
    restores them from the newest row (the test above)."""
    import pytest

    from dbaf_tpu.slam.system import DBAFusion
    from tests.test_async_pipeline import make_cfg as jax_cfg, make_fns, make_scene as scene
    from tests.test_torch_async_pipeline import INTR_FULL, frames

    gt_poses, gt_disps = scene(10, INTR)

    def system():
        cfg = jax_cfg(False)
        fns = make_fns(gt_poses, gt_disps, INTR, cfg.buffer)
        return DBAFusion(cfg, feat_fn=fns[0], ctx_fn=fns[1], update_fn=fns[2])

    imgs = frames(10)
    a = system()
    for k in range(9):
        a.track(float(k), imgs[k], intrinsics=INTR_FULL)
    path = str(tmp_path / "jax_state.pkl")
    a.save_state(path)
    b = system()
    b.load_state(path)
    assert b.filter._kf_fmap is None
    with pytest.raises(AttributeError):  # the gate reads the keyframe's shape from None
        b.track(9.0, imgs[9], intrinsics=INTR_FULL)


def test_coupled_save_load_state_roundtrip(tmp_path):
    """The coupled path (test_torch_coupled.py's scenario on the device
    solver): saved at keyframe 18, after VI initialization, and resumed for
    four keyframes, at the JAX test's bounds on the poses and on the solved
    body positions (measured equal to the bit)."""
    from dbaf_tpu_torch.utils import config as tconfig
    from tests.test_torch_coupled import FPS, PortHarness as MsHarness, _cfg, _scene

    imu_rows, _, gt_cw, gt_disps = _scene()
    cfg = _cfg(tconfig, True)

    def positions(h):
        return np.asarray([h.graph.coupled.state.wTbs[i].t for i in range(h.frontend.t1)])

    h = MsHarness(cfg, gt_cw, gt_disps, imu_rows)
    for k in range(18):
        h.feed(k)
    assert h.video.imu_enabled
    path = str(tmp_path / "coupled.pkl")
    _facade(h.video, h.graph, h.frontend).save_state(path)
    assert _load_file(path)["coupled"].video is None
    saved = h.video.poses[:h.frontend.t1].numpy().copy(), positions(h)
    for k in range(18, 22):
        h.feed(k)
    h2 = MsHarness(cfg, gt_cw, gt_disps, imu_rows)
    _facade(h2.video, h2.graph, h2.frontend).load_state(path)
    assert h2.graph.coupled.video is h2.video
    np.testing.assert_allclose(h2.video.poses[:h2.frontend.t1].numpy(), saved[0], atol=1e-6)
    np.testing.assert_allclose(positions(h2), saved[1], atol=1e-6)
    n = h2.video.counter
    h2.id_map[:n] = np.round(h2.video.tstamp[:n] * FPS).astype(np.int64)
    for k in range(18, 22):
        h2.feed(k)
    assert h2.frontend.t1 == h.frontend.t1
    np.testing.assert_allclose(h2.video.poses[:h2.frontend.t1].numpy(),
                               h.video.poses[:h.frontend.t1].numpy(), atol=1e-4)
    np.testing.assert_allclose(positions(h2), positions(h), atol=1e-4)
