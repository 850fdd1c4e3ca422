"""The tightly-coupled path through the port's entry points --
``DBAFusion(cfg, device=...)``, ``set_multisensor``, ``track`` on every
frame, ``terminate`` and ``trajectory_ecef`` -- with both window solvers (the
device factor graph with the fused coupled step, and the host f64 graph)
and with the asynchronous coupled pipeline.

The frames are procedural images; the feature and context networks are
stand-ins returning zeros, and the update operator is the synthetic-scene
oracle of ``dbaf_tpu_torch/eval/synthetic.py`` (the motion gate gets a zero
flow and admits every frame), so the trajectory is metric and VI
initialization triggers.  The accuracy bounds are those of
``tests/test_slam_multisensor.py``: SE3-aligned ATE of the body positions
under 8% of the span and every |bias| under 0.2.

This file imports neither JAX nor the JAX package; its card cases run where
only PyTorch is installed:

    python -m pytest --noconftest -m cuda -q tests/test_torch_coupled_entry.py
"""

import numpy as np
import pytest
import torch

FPS = 10.0
N_FRAMES = 30
H8, W8 = 8, 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's eager solve is thousands of small ops: one intra-op thread
    runs them as fast, and keeps parallel test workers from oversubscribing
    the cores (spinning OpenMP threads slow every worker many times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(device_solver: bool, coupled_async: bool = False):
    from dbaf_tpu_torch.utils.config import tumvi_config

    cfg = tumvi_config(image_size=(8 * H8, 8 * W8))
    cfg.buffer = 48
    cfg.ba.window = 32
    cfg.frontend.vi_warmup = 12
    cfg.frontend.filter_thresh = -1.0   # admit every frame
    cfg.frontend.keyframe_thresh = -1.0  # no flow culls at this small grid
    cfg.sensors.device_solver = device_solver
    cfg.sensors.coupled_async = coupled_async
    return cfg


def run_entry_points(dev: torch.device, device_solver: bool, coupled_async: bool = False,
                     guard: int = 0) -> dict:
    """The scenario through the entry points; with ``guard`` (on the card)
    that many steady-state keyframes of the asynchronous pipeline run under
    ``torch.cuda.set_sync_debug_mode("error")``, where any synchronising
    call but the pipeline's lagged drain and the motion gate's read raises.
    The oracle's frame map is uploaded without a synchronisation
    (``utils.device.upload``)."""
    from dbaf_tpu_torch.eval.ate import ate_rmse
    from dbaf_tpu_torch.eval.synthetic import (make_oracle, scene_from_poses,
                                               simulate_imu_and_poses)
    from dbaf_tpu_torch.slam.system import DBAFusion
    from dbaf_tpu_torch.utils.device import upload

    cfg = _config(device_solver, coupled_async)
    intr8 = np.asarray([2.0 * W8, 2.0 * W8, W8 / 2, H8 / 2], np.float32)
    imu_rows, poses_at = simulate_imu_and_poses(N_FRAMES / FPS + 0.5, fps=FPS)
    gt_cw, gt_disps = scene_from_poses(poses_at, N_FRAMES, intr8, H8, W8)
    oracle = make_oracle(gt_cw, gt_disps, intr8, device=dev)

    def feat_fn(images):
        return torch.zeros((1, H8, W8, 128), dtype=torch.bfloat16, device=dev)

    def ctx_fn(images):
        return feat_fn(images), feat_fn(images)

    def update_fn(net, inp, corr, motn, ii, jj, aux):
        if "id_map" not in aux:  # the motion gate: no flow
            return net, torch.zeros(net.shape[:3] + (2,), device=dev), \
                torch.ones(net.shape[:3] + (2,), device=dev)
        return oracle(net, inp, corr, motn, ii, jj, aux)

    system = DBAFusion(cfg, device=dev, feat_fn=feat_fn, ctx_fn=ctx_fn, update_fn=update_fn)
    coupled = system.set_multisensor(imu_rows, np.eye(4), imu_noise=[0.05, 0.005, 1e-4, 1e-6])
    v, g = system.video, system.graph
    id_map = np.zeros(cfg.buffer, np.int64)
    image = np.zeros((8 * H8, 8 * W8, 3), np.uint8)
    guarded = 0
    for k in range(N_FRAMES):
        id_map[v.counter] = k
        g.aux = {"id_map": upload(id_map, dev)}
        ca = system.frontend._casync
        steady = guarded < guard and ca is not None and ca.active
        if steady:
            torch.cuda.set_sync_debug_mode("error")
        try:
            system.track(k / FPS, image, intrinsics=intr8 * 8.0)
        finally:
            if steady:
                torch.cuda.set_sync_debug_mode(0)
        guarded += steady
        n = v.counter
        id_map[:n] = np.round(v.tstamp[:n] * FPS).astype(np.int64)
    ca = system.frontend._casync
    async_steps = ca.total_steps if ca is not None else 0
    traj = system.terminate()
    t1 = system.frontend.t1
    st = coupled.state
    est = np.asarray([st.wTbs[k].t for k in range(t1)])
    ref = np.stack([poses_at[i][1] for i in np.round(v.tstamp[:t1] * FPS).astype(int)])
    return dict(imu=v.imu_enabled, traj=traj, ecef=system.trajectory_ecef,
                megas=g.mega_count, steps=system.frontend.keyframe_steps,
                ate=ate_rmse(est, ref, align="se3"),
                span=np.linalg.norm(ref.max(0) - ref.min(0)),
                bias=np.abs(np.asarray([st.bs[k] for k in range(t1)])).max(),
                async_steps=async_steps, guarded=guarded)


def _check(r, device_solver, coupled_async=False):
    assert r["imu"], "VI initialization did not trigger"
    assert (r["async_steps"] >= 6) if coupled_async else (r["async_steps"] == 0)
    assert r["traj"].shape == (r["steps"], 8) and np.all(np.isfinite(r["traj"]))
    assert r["ecef"] == {}  # no GNSS: never georeferenced
    assert r["ate"] < 0.08 * r["span"], (r["ate"], r["span"])
    assert r["bias"] < 0.2
    if device_solver:
        assert r["megas"] >= 10  # the fused coupled step ran
    else:
        assert r["megas"] == 0  # the host f64 graph never takes it


@pytest.mark.parametrize("device_solver", [True, False])
def test_coupled_entry_points_cpu(device_solver):
    _check(run_entry_points(torch.device("cpu"), device_solver), device_solver)


@pytest.mark.cuda
@pytest.mark.parametrize("device_solver", [True, False])
def test_coupled_entry_points_on_the_card(device_solver):
    """The same run on the card: K1 in every update round."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the correlation kernels have no CPU mode")
    from dbaf_tpu_torch.ops import corr_cuda as cc

    cc.reset_launch_counts()
    r = run_entry_points(torch.device("cuda"), device_solver)
    _check(r, device_solver)
    assert cc.LAUNCHES["corr_fused_xy"] > 0 and cc.LAUNCHES["corr_lookup"] == N_FRAMES - 1


def test_coupled_async_entry_points_cpu():
    """The JAX package's default coupled flags (device solver, fused step,
    asynchronous pipeline) through the entry points: the pipeline runs
    every keyframe after its activation and terminate drains it."""
    _check(run_entry_points(torch.device("cpu"), True, coupled_async=True), True, True)


@pytest.mark.cuda
def test_coupled_async_entry_points_on_the_card():
    """The pipeline on the card, five steady-state keyframes under
    ``set_sync_debug_mode("error")``: no call of the step synchronises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the correlation kernels have no CPU mode")
    from dbaf_tpu_torch.ops import corr_cuda as cc

    cc.reset_launch_counts()
    r = run_entry_points(torch.device("cuda"), True, coupled_async=True, guard=5)
    _check(r, True, True)
    assert r["guarded"] == 5
    assert cc.LAUNCHES["corr_fused_xy"] > 0 and cc.LAUNCHES["corr_lookup"] == N_FRAMES - 1
