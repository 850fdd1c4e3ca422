"""IMU-rate trajectory rows (``all_stamp``) through the port's coupled
flows: ``tests/test_flagship_outputs.py::test_imu_rate_output_rides_flagship_pipeline``
(``:128-150``, slow in the JAX package) on the port, port-async against
port-sync under that test's bounds, and port-sync against the JAX
package's synchronous flow.

``test_torch_coupled_async.py``'s VIO scene, 28 frames at 10 fps with
full-rate stamps at 30 Hz (the JAX test's); the port's synchronous run is
a copy of the harness taken at the pipeline's activation.  Held:

- port-async against port-sync: the pipeline activates and runs >= 5
  steps; the row schedule (keyframe rows and the IMU-rate rows between
  them) is the synchronous flow's exactly; at least 10 rows fall strictly
  between keyframes; positions within 5e-2 m (the rows propagate from
  host mirrors one solve behind the synchronous flow's);
- port-sync against the JAX package's synchronous flow
  (``test_slam_multisensor.py::MsHarness``, the same scene, stamps and
  configuration with ``coupled_async`` off): the row times equal, the
  rows' positions within 3e-2 m, the bound of
  ``test_torch_coupled.py::test_coupled_e2e_matches_jax`` (measured
  2.88e-2 on one thread: the coupled solve amplifies f32 round-off, as
  that file's docstring sets out), and their quaternions within 1e-2 per
  component (measured 1.5e-3).  The positions alone cannot see a fault in
  the propagation between keyframes: over a third of a frame interval it
  moves a row by millimetres.  The orientation can: with the gyro rates
  left in deg/s in the propagation the IMU-rate rows' quaternions differ
  from JAX's by 0.45, their positions still by under 3e-2 m.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_slam_multisensor import FPS, MsHarness
from tests.test_torch_coupled import INTR, PortHarness
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_coupled_async import config, scene

N_FRAMES = 28


def _stamps():
    return np.asarray([[k / 30.0] for k in range(int(N_FRAMES / FPS * 30))])


def _rows(h):
    """The trajectory's row times and (N, 7) poses (position, quaternion)."""
    rows = [(t, np.asarray(p, np.float64)) for t, p in h.frontend.trajectory]
    return np.asarray([t for t, _ in rows]), np.stack([p for _, p in rows])


@pytest.fixture(scope="module")
def the_scene():
    return scene(N_FRAMES)


@pytest.fixture(scope="module")
def port_runs(the_scene):
    """(async harness, synchronous copy) after the drain, on one torch
    thread: a module fixture is set up before the autouse
    ``one_torch_thread``, and with every thread parallel workers
    oversubscribe the cores."""
    from dbaf_tpu_torch.utils import config as tconfig

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        imu_rows, _, gt_cw, gt_disps = the_scene
        h = PortHarness(config(tconfig), gt_cw, gt_disps, imu_rows)
        h.frontend.set_multisensor(imu_rows, all_stamp=_stamps(), visual_only=False)
        sync = None
        for k in range(N_FRAMES):
            h.feed(k)
            ca = h.frontend._casync
            if sync is None and ca is not None and ca.active:
                sync = copy.deepcopy(h)
                sync.frontend.cfg.sensors.coupled_async = False
                sync.frontend._casync = None
            elif sync is not None:
                sync.feed(k)
        assert sync is not None, "the async pipeline never activated"
        h.frontend.drain_async()
    finally:
        torch.set_num_threads(n_threads)
    return h, sync


def test_imu_rate_rows_ride_the_coupled_pipeline(port_runs):
    h, sync = port_runs
    ca = h.frontend._casync
    assert ca.total_steps >= 5, ca.total_steps

    t_a, p_a = _rows(h)
    t_s, p_s = _rows(sync)
    np.testing.assert_array_equal(t_a, t_s)  # the same row schedule
    frac = np.abs(t_a * FPS - np.round(t_a * FPS))
    assert int(np.sum(frac > 1e-6)) >= 10  # IMU-rate rows strictly between keyframes
    assert len(t_a) > h.frontend.keyframe_steps
    np.testing.assert_allclose(p_a[:, :3], p_s[:, :3], atol=5e-2)
    assert np.all(np.isfinite(p_a))


def test_imu_rate_rows_match_jax(the_scene, port_runs):
    from dbaf_tpu.utils import config as jconfig

    imu_rows, _, gt_cw, gt_disps = the_scene
    j = MsHarness(config(jconfig, coupled_async=False), jnp.asarray(gt_cw),
                  jnp.asarray(gt_disps), INTR, imu_rows)
    j.frontend.set_multisensor(imu_rows, all_stamp=_stamps(), visual_only=False)
    for k in range(N_FRAMES):
        j.feed(k)
    j.frontend.drain_async()

    t_j, p_j = _rows(j)
    t_s, p_s = _rows(port_runs[1])
    np.testing.assert_array_equal(t_s, t_j)  # the same row schedule as JAX
    frac = np.abs(t_j * FPS - np.round(t_j * FPS))
    assert int(np.sum(frac > 1e-6)) >= 10
    np.testing.assert_allclose(p_s[:, :3], p_j[:, :3], atol=3e-2)
    q_s, q_j = p_s[:, 3:], p_j[:, 3:]
    q_s = q_s * np.sign(np.sum(q_s * q_j, axis=1, keepdims=True))  # q and -q are one rotation
    np.testing.assert_allclose(q_s, q_j, atol=1e-2)
