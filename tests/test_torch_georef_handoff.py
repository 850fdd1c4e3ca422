"""The georeferencing handoff on the port: ``tests/test_georef.py:75``'s
scenario and assertions (``slow`` in the reference), with no JAX run.

52 frames of the analytic excitation trajectory plus a 12 m/s forward
drift, buffer 64, the device factor graph, the fused step and the
asynchronous pipeline on.  GNSS rows are the ECEF image of the true
trajectory in a yawed, offset ENU frame, so ``init_gnss`` has a heading,
an offset and a scale to solve.  The pipeline must wait for that
initialization (``CoupledAsync.can_activate``) and reactivate after it; the
live window's positions must meet
the reference's absolute bounds in the georeferenced frame (max error
under 0.08 x span, median under 0.05 x span) and its SE3-aligned ATE under
0.05 x span.  The scene culls no keyframe, so no drain here has a cull
pending; the drain's ``rm_new_gnss`` with GNSS rows is held in
``test_torch_coupled_async_gnss_odo.py``.
"""

import numpy as np
import pytest
import torch

from tests.test_georef import N_FRAMES, _enu_of_gt, _simulate_fast
from tests.test_torch_coupled import PortHarness, _cfg
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_coupled_async import scene

FPS = 10.0
TEN0_BASE = np.array([-2694045.0, -4293642.0, 3857878.0])


def gnss_rows_of(poses_at, n):
    """The ECEF image of the true trajectory in the yawed ENU frame
    (test_georef.py:101-107)."""
    from dbaf_tpu_torch.utils import geodesy

    Cen = geodesy.Cen(TEN0_BASE)
    return np.asarray([np.concatenate([[k / FPS], TEN0_BASE + Cen @ _enu_of_gt(poses_at[k][1])])
                       for k in range(n)])


@pytest.fixture(scope="module")
def handoff_run():
    from dbaf_tpu_torch.utils import config as tconfig

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)  # a module fixture is set up before the autouse one
    try:
        imu_rows, poses_at, gt_cw, gt_disps = scene(N_FRAMES, _simulate_fast)
        gnss_rows = gnss_rows_of(poses_at, N_FRAMES)
        cfg = _cfg(tconfig)
        cfg.buffer = 64  # 52 admissions, no culls on this scene
        cfg.frontend.rollup_shift = 8
        cfg.frontend.translation_threshold = -1.0
        cfg.sensors.coupled_async = True
        h = PortHarness(cfg, gt_cw, gt_disps, imu_rows)
        h.frontend.set_multisensor(imu_rows, all_gnss=gnss_rows, visual_only=False)
        coupled = h.graph.coupled
        coupled.ten0 = gnss_rows[0, 1:4].copy()  # as apps/demo_whu.py seeds it
        init_frame = steps_at_init = None
        active_before_init = False
        for k in range(N_FRAMES):
            ca = h.frontend._casync
            active_before_init |= ca is not None and ca.active and coupled.gnss_init_t1 <= 0
            h.feed(k)
            ca = h.frontend._casync
            if init_frame is None and coupled.gnss_init_t1 > 0:
                init_frame = k
                steps_at_init = ca.total_steps if ca is not None else 0
        ca = h.frontend._casync
        active_at_end = ca is not None and ca.active
        h.frontend.drain_async()
        t1, lo = h.frontend.t1, coupled.last_t0
        est = np.asarray([coupled.state.wTbs[i].t for i in range(lo, t1)])
        gt_ids = np.round(h.video.tstamp[lo:t1] * FPS).astype(int)
        return dict(h=h, poses_at=poses_at, init_frame=init_frame, steps_at_init=steps_at_init,
                    active_before_init=active_before_init, active_at_end=active_at_end,
                    est=est, gt_ids=gt_ids)
    finally:
        torch.set_num_threads(n_threads)


def test_pipeline_waits_for_init_gnss_and_reactivates(handoff_run):
    r = handoff_run
    h = r["h"]
    coupled = h.graph.coupled
    assert h.video.imu_enabled, "VI init did not trigger"
    assert r["init_frame"] is not None, "init_gnss never fired (baseline?)"
    assert coupled.gnss_init_time > 0.0
    # not active before georeferencing (CoupledAsync.can_activate waits)
    assert r["steps_at_init"] == 0 and not r["active_before_init"]
    ca = h.frontend._casync
    assert r["active_at_end"], "the pipeline did not reactivate"
    assert ca.total_steps >= 5, ca.total_steps


def test_georeferenced_rows_meet_the_reference_bounds(handoff_run):
    from dbaf_tpu_torch.eval.ate import ate_rmse
    from dbaf_tpu_torch.utils import geodesy

    r = handoff_run
    coupled = r["h"].graph.coupled
    Cen = geodesy.Cen(TEN0_BASE)
    Cen0 = geodesy.Cen(coupled.ten0)
    ref_local = np.stack([Cen0.T @ (TEN0_BASE + Cen @ _enu_of_gt(r["poses_at"][g][1]) - coupled.ten0)
                          for g in r["gt_ids"]])
    span = np.linalg.norm(ref_local.max(0) - ref_local.min(0))
    err = np.linalg.norm(r["est"] - ref_local, axis=1)
    assert err.max() < 0.08 * span, (err.max(), span)
    assert np.median(err) < 0.05 * span, (np.median(err), span)
    ref_gt = np.stack([r["poses_at"][g][1] for g in r["gt_ids"]])
    rmse = ate_rmse(r["est"], ref_gt, align="se3")
    assert rmse < 0.05 * span, (rmse, span)
