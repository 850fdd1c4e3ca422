"""ZUPT stop-and-go on the port: ``tests/test_zupt.py:279,317``'s scenario
and assertions (both ``slow`` in the reference), with no JAX run.

100 frames of the multisensor trajectory through a time warp that ramps to
a dead stop at ``T_STOP`` (4.0 s), stays there until ``T_RESUME`` (9.4 s)
and ramps back; buffer 80, ``keyframe_thresh`` 0.1, the 0.2 m translation
hysteresis, the device factor graph and the fused step, ZUPT on with the
reference's scene-level velocity gate of 0.12 m/s; plateau frames admitted
at the motion filter's sparse cadence (``test_zupt._admit``).  Organic gate
fires are recorded through a wrapped ``Frontend._zupt_gate``, as the
reference records them.

One module fixture runs the synchronous and the asynchronous flow once
each, as ``_run_zupt_cached`` does.  They share their frames up to the
pipeline's activation: the harness is copied there, and the copy continues
on the synchronous flow (``test_torch_coupled_async.run_port``'s scheme).
In the asynchronous run the bias reinitialization (5 s after VI init) falls
on the plateau: it drains the pipeline, which enters again later.
"""

import copy

import numpy as np
import pytest
import torch

from tests.test_slam_multisensor import body_state
from tests.test_torch_coupled import FPS, PortHarness, _cfg
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_coupled_async import scene
from tests.test_zupt import N_FRAMES, T_RESUME, T_STOP, TAU, _admit, _simulate_warped, _warp


def zupt_config():
    """test_zupt.py::_run_zupt's configuration on the port."""
    from dbaf_tpu_torch.utils import config as tconfig

    cfg = _cfg(tconfig)
    cfg.buffer = 80
    cfg.frontend.keyframe_thresh = 0.1
    cfg.frontend.rollup_shift = 8
    cfg.frontend.translation_threshold = 0.2
    cfg.sensors.coupled_async = True
    cfg.sensors.use_zupt = True
    cfg.sensors.zupt_vel_thresh = 0.12
    return cfg


def record_gate(fe, fires):
    """Wrap ``fe._zupt_gate`` to append the stamp of each organic fire."""
    gate = type(fe)._zupt_gate.__get__(fe)

    def recording(cur_t):
        fired = gate(cur_t)
        if fired:
            fires.append(float(cur_t))
        return fired

    fe._zupt_gate = recording


def readings(h, poses_at, fires, vi_k):
    h.frontend.drain_async()
    t1, lo = h.frontend.t1, h.graph.coupled.last_t0
    state = h.graph.coupled.state
    stamps = np.asarray(h.video.tstamp[:t1])
    gt_ids = np.round(stamps[lo:t1] * FPS).astype(int)
    ca = h.frontend._casync
    rows = np.stack([np.concatenate([[t], np.asarray(p, np.float64)[:3]])
                     for t, p in h.frontend.trajectory])
    return dict(t1=t1, lo=lo, stamps=stamps, imu=h.video.imu_enabled, fires=list(fires),
                est=np.asarray([state.wTbs[k].t for k in range(lo, t1)]),
                ref=np.stack([poses_at[g][1] for g in gt_ids]),
                steps=ca.total_steps if ca else 0, culls=ca.culls if ca else 0,
                plateau_dev=plateau_rows_dev(rows, poses_at, vi_k / FPS))


def plateau_rows_dev(rows, poses_at, t_vi):
    """The trajectory rows stamped on the plateau against the true stop
    point, the rows from VI initialization on SE3-aligned to the truth:
    (number of rows, largest distance).  The live window holds only
    keyframes after the resume, so the reference's window check below never
    sees the stop; the rows, one per keyframe step, do."""
    from dbaf_tpu_torch.eval.ate import umeyama

    t, pos = rows[:, 0], rows[:, 1:4]
    truth = np.stack([poses_at[int(round(x * FPS))][1] for x in t])
    vi = t >= t_vi - 1e-9
    _, R, tw = umeyama(pos[vi], truth[vi], with_scale=False)
    on = (t > T_STOP + TAU) & (t < T_RESUME)
    stop_p = body_state(_warp(T_STOP + TAU)[0])[0]
    dev = np.linalg.norm(pos[on] @ R.T + tw - stop_p, axis=1)
    return int(on.sum()), float(dev.max()) if on.any() else np.inf


@pytest.fixture(scope="module")
def zupt_runs():
    """(async readings, sync readings)."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)  # a module fixture is set up before the autouse one
    try:
        imu_rows, poses_at, gt_cw, gt_disps = scene(N_FRAMES, _simulate_warped)
        h = PortHarness(zupt_config(), gt_cw, gt_disps, imu_rows)
        assert h.frontend.use_zupt
        fires_a, fires_s = [], None
        record_gate(h.frontend, fires_a)
        sync = vi_k = None
        for k in range(N_FRAMES):
            if not _admit(k):
                continue
            h.feed(k)
            if vi_k is None and h.video.imu_enabled:
                vi_k = k
            ca = h.frontend._casync
            if sync is None and ca is not None and ca.active:
                sync = copy.deepcopy(h)
                sync.frontend.cfg.sensors.coupled_async = False
                sync.frontend._casync = None
                fires_s = list(fires_a)
                record_gate(sync.frontend, fires_s)
            elif sync is not None:
                sync.feed(k)
        assert sync is not None, "the async pipeline never activated"
        return readings(h, poses_at, fires_a, vi_k), readings(sync, poses_at, fires_s, vi_k)
    finally:
        torch.set_num_threads(n_threads)


def test_zupt_gate_fires_reference_semantics(zupt_runs):
    """test_zupt.py:279 on the port's synchronous flow."""
    from dbaf_tpu_torch.eval.ate import ate_rmse

    _, s = zupt_runs
    assert s["imu"], "VI init did not trigger before the stop"
    n_feeds = sum(_admit(k) for k in range(N_FRAMES))
    assert s["t1"] <= n_feeds - 8, (s["t1"], n_feeds)  # the plateau culls
    assert len(s["fires"]) >= 3, s["fires"]
    times = np.asarray(s["fires"])
    assert times.min() >= T_STOP + 3.0, times.min()
    assert times.max() <= T_RESUME + TAU, times.max()
    # every window keyframe stamped inside the plateau sits within 10 cm of
    # the true stop point
    stop_p = body_state(_warp(T_STOP + TAU)[0])[0]
    stamps = s["stamps"][s["lo"]:s["t1"]]
    in_plateau = (stamps > T_STOP + TAU) & (stamps < T_RESUME)
    if np.any(in_plateau):
        dev = np.linalg.norm(s["est"][in_plateau] - stop_p, axis=1)
        assert dev.max() < 0.10, dev.max()
    # the same bound on the trajectory rows of the plateau's keyframes
    n_rows, row_dev = s["plateau_dev"]
    assert n_rows >= 3 and row_dev < 0.10, s["plateau_dev"]
    rmse = ate_rmse(s["est"], s["ref"], align="se3")
    span = np.linalg.norm(s["ref"].max(0) - s["ref"].min(0))
    assert rmse < 0.08 * span, (rmse, span)


def test_zupt_async_matches_sync(zupt_runs):
    """test_zupt.py:317: the pipeline's gate reads a velocity mirror one
    keyframe behind the solve, and must fire as the synchronous flow does
    up to that boundary."""
    from dbaf_tpu_torch.eval.ate import ate_rmse

    a, s = zupt_runs
    assert a["steps"] >= 10, a["steps"]
    assert a["culls"] >= 6, a["culls"]  # the stationary culls ran inside the pipeline
    assert a["t1"] == s["t1"], (a["t1"], s["t1"])
    np.testing.assert_array_equal(a["stamps"], s["stamps"])  # identical cull decisions
    ta, ts_ = set(np.round(a["fires"], 6)), set(np.round(s["fires"], 6))
    diff = ta.symmetric_difference(ts_)
    assert len(diff) <= 2, (sorted(diff), len(ta), len(ts_))
    assert len(ta) >= 3 and len(ts_) >= 3, (len(ta), len(ts_))
    assert abs(a["fires"][0] - s["fires"][0]) <= 2.0 / FPS + 1e-9, (a["fires"][0], s["fires"][0])
    np.testing.assert_allclose(a["est"], s["est"], atol=5e-2)
    n_rows, row_dev = a["plateau_dev"]
    assert n_rows >= 3 and row_dev < 0.10, a["plateau_dev"]
    ate_a = ate_rmse(a["est"], a["ref"], align="se3")
    ate_s = ate_rmse(s["est"], s["ref"], align="se3")
    span = np.linalg.norm(s["ref"].max(0) - s["ref"].min(0))
    assert ate_s < 0.08 * span, (ate_s, span)
    assert ate_a < max(1.3 * ate_s, ate_s + 0.005 * span), (ate_a, ate_s)
