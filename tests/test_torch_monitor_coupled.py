"""The monitor on the asynchronous coupled pipeline, port-async against
port-sync: ``tests/test_coupled_async.py::test_monitor_rides_async_drain``
(slow in the JAX package) on the port, under its own assertions, and the
monitor's rows held against the synchronous flow's.

``test_torch_coupled_async.py``'s 24-frame VIO scene with the monitor on and
its debug views off; the synchronous run is a copy of the harness taken at
the pipeline's activation (``test_torch_save_pkl_coupled.py``'s pattern).
Each drained pack feeds the monitor one row, so after the final drain both
runs hold one row per keyframe step at the same stamps, exactly.  The
pipeline's row is the decision-time body pose (the trajectory row of its
stamp, to 1e-5, as the JAX test holds it); the synchronous flow records the
solved pose after the step's last round, so positions are held to
``test_torch_coupled_async.py``'s 2e-2 m between the flows, and the gyro
biases (the solved window state in both) to 1e-3.
"""

import copy

import numpy as np

from tests.test_torch_coupled import PortHarness
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_coupled_async import config, scene


def test_monitor_rides_the_coupled_pipeline(tmp_path):
    from dbaf_tpu_torch.utils import config as tconfig

    n = 24
    imu_rows, _, gt_cw, gt_disps = scene(n)
    cfg = config(tconfig)
    cfg.frontend.monitor_dir = str(tmp_path)
    cfg.frontend.monitor_debug = False
    h = PortHarness(cfg, gt_cw, gt_disps, imu_rows)
    sync = None
    for k in range(n):
        h.feed(k)
        ca = h.frontend._casync
        if sync is None and ca is not None and ca.active:
            sync = copy.deepcopy(h)
            sync.frontend.cfg.sensors.coupled_async = False
            sync.frontend._casync = None
        elif sync is not None:
            sync.feed(k)
    assert sync is not None, "the async pipeline never activated"
    ca = h.frontend._casync
    assert ca.total_steps >= 4, ca.total_steps  # the pipeline stays active with the monitor
    mon = h.frontend.monitor
    # one row per drained step and the sync keyframes before activation;
    # the last pack is still pending: a lag of one
    assert len(mon.t) == h.frontend.keyframe_steps - 1
    assert np.any(np.abs(np.asarray(mon.bg[-3:])) > 0)  # from the pack's window state
    h.frontend.drain_async()  # records the pending pack's row
    mon_s = sync.frontend.monitor
    assert len(mon.t) == h.frontend.keyframe_steps == len(mon_s.t)
    np.testing.assert_array_equal(mon.t, mon_s.t)

    traj = {t: np.asarray(p, np.float64)[:3] for t, p in h.frontend.trajectory}
    n_async = ca.total_steps
    for t, p in zip(mon.t[-n_async:], mon.pos[-n_async:]):
        np.testing.assert_allclose(p, traj[t], atol=1e-5)
    np.testing.assert_allclose(np.asarray(mon.pos), np.asarray(mon_s.pos), atol=2e-2)
    np.testing.assert_allclose(np.asarray(mon.bg), np.asarray(mon_s.bg), atol=1e-3)
    assert mon.dumps == {}  # no rollup in this scene: no summary
    assert mon.dump_summary().endswith("monitor_0000.png")
