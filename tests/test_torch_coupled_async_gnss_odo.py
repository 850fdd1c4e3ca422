"""GNSS and wheel odometry inside the asynchronous coupled pipeline
(``tests/test_coupled_async.py:264``, ``slow`` in the reference): 30 frames
of the VIO scene with keyframe culls (``keyframe_thresh=0.05``,
``translation_threshold=0.35``), the device factor graph and the fused step.

Phase A runs the port's synchronous flow without GNSS and fits its
estimated world frame to the true one (Umeyama, no scale).  The GNSS rows
are then the true positions in that estimated frame, as ECEF about a
``ten0``, and the odometry rows the true body-frame velocities, one of each
per frame, so every keyframe carries both; the run starts georeferenced.
The same rows go to the port's async and sync runs and to the JAX
package's async run (in a spawned process).

Bounds.  Port-async against port-sync at ``test_coupled_async.py:300-330``:
the same keyframe stamps, edge sets and window origin, window positions and
trajectory rows within 5e-2 m, disparities within 2e-2, the ATE rule.
Port-async against JAX-async at the synchronous port test's bounds: the
same keyframes and culls, positions within 3e-2 m, biases within 1e-4.  The
pipeline must cull inside itself a keyframe that carries a GNSS or an
odometry row, so that the step's device re-link
(``coupled_async._relink_culled_gnss_odo``) runs end to end.
"""

import contextlib

import numpy as np

from tests.test_slam_multisensor import body_state
from tests.test_torch_coupled import FPS, PortHarness
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_coupled_async import check_case, config, run_both, scene, summary

N = 30
CULLS = dict(keyframe_thresh=0.05, translation_threshold=0.35)
TEN0 = np.array([-2694045.0, -4293642.0, 3857878.0])


def sensor_rows(n):
    """Phase A and the rows built from its fit (test_coupled_async.py:280-303)."""
    from dbaf_tpu_torch.eval.ate import umeyama
    from dbaf_tpu_torch.utils import geodesy

    from dbaf_tpu_torch.utils import config as tconfig

    imu_rows, poses_at, gt_cw, gt_disps = scene(N)
    h = PortHarness(config(tconfig, coupled_async=False, **CULLS), gt_cw, gt_disps, imu_rows)
    for k in range(N):
        h.feed(k)
    sync0 = summary(h, poses_at)
    _, Rw, tw = umeyama(sync0["ref"], sync0["est"], with_scale=False)
    Cen = geodesy.Cen(TEN0)
    gnss, odo = [], []
    for k in range(N):
        t = k / FPS
        p_gt, v_gt, _, _ = body_state(t)
        gnss.append(np.concatenate([[t], TEN0 + Cen @ (Rw @ p_gt + tw)]))
        odo.append(np.concatenate([[t], poses_at[k][0].T @ v_gt]))
    return dict(gnss=np.asarray(gnss), odo=np.asarray(odo), ten0=TEN0)


@contextlib.contextmanager
def culled_rows():
    """Record, for each host mirror of a device cull
    (``CoupledAsync._host_apply_cull``), whether the culled keyframe carried
    a GNSS row (packed once georeferenced) and an odometry row."""
    from dbaf_tpu_torch.slam.coupled_async import CoupledAsync

    rec = []
    apply0 = CoupledAsync._host_apply_cull

    def apply(self, c):
        coupled = self.fe.coupled
        st = coupled.state
        rec.append((bool(st.gnss_valid[c]) and coupled.gnss_init_t1 > 0, bool(st.odo_valid[c])))
        return apply0(self, c)

    CoupledAsync._host_apply_cull = apply
    try:
        yield rec
    finally:
        CoupledAsync._host_apply_cull = apply0


def test_gnss_odo_async_matches_sync_and_jax():
    from dbaf_tpu_torch.eval.ate import ate_rmse

    sensors = sensor_rows(N)
    with culled_rows() as culled:
        a, s, j = run_both(N, sensors=sensors, **CULLS)
    check_case(a, s, j, min_steps=5)
    # GNSS and odometry rows are attached in the window, in both packages
    assert a["gnss"] > 0 and a["odo"] > 0 and (j["gnss"], j["odo"]) == (a["gnss"], a["odo"])
    # culls inside the pipeline, of keyframes that carry both rows
    assert a["culls"] >= 1 and any(g or o for g, o in culled), (a["culls"], culled)
    # test_coupled_async.py:320-330 against the port's synchronous flow
    np.testing.assert_allclose(a["est"], s["est"], atol=5e-2)
    np.testing.assert_allclose(a["disps"], s["disps"], atol=2e-2)
    np.testing.assert_allclose(a["traj"][:, :3], s["traj"][:, :3], atol=5e-2)
    span = np.linalg.norm(s["ref"].max(0) - s["ref"].min(0))
    ate_a = ate_rmse(a["est"], a["ref"], align="se3")
    ate_s = ate_rmse(s["est"], s["ref"], align="se3")
    assert ate_s < 0.08 * span and ate_a < max(1.3 * ate_s, ate_s + 0.005 * span), (ate_a, ate_s)
