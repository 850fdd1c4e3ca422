"""The coupled window past the keyframe buffer's end, end to end on the CPU.

``test_torch_coupled.py``'s 26-frame scenario with a 28-slot buffer and a
20-slot BA window, so the factor-graph window starts past slot 8 and
``s0 + P`` runs past the buffer (ROADMAP Queue 3).  The port keeps slot
``l`` as frame ``s0 + l`` there (``ops/dba.py::window_rows``).  It is held
against the JAX package with a 48-slot buffer, where the same window fits
and ``jax.lax.dynamic_slice`` does not clamp, at the bounds of
``test_torch_coupled.py``: the same keyframes, VI-initialization point and
fused-step count, positions to 3e-2 m (measured 7.7e-3), biases to 1e-4
(measured 7.4e-7).  The JAX package at the 28-slot buffer itself clamps the
window start to ``B - P``: it keeps other keyframes (22 against 21) and its
SE3-aligned ATE reaches 0.167 x span, past its own test's 0.08 bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_slam_multisensor import MsHarness
from tests.test_torch_coupled import INTR, PortHarness, _accuracy_asserts, _cfg, _run, _scene
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)

BUFFER, WINDOW = 28, 20


@pytest.fixture(scope="module")
def scene():
    return _scene()


def _jax_run(scene, buffer):
    from dbaf_tpu.utils import config as jconfig

    imu_rows, poses_at, gt_cw, gt_disps = scene
    cfg = _cfg(jconfig)
    cfg.buffer, cfg.ba.window = buffer, WINDOW
    h = MsHarness(cfg, jnp.asarray(gt_cw), jnp.asarray(gt_disps), INTR, imu_rows)
    return _run(h, poses_at)


@pytest.fixture(scope="module")
def jax_window_fits(scene):
    return _jax_run(scene, 48)


def test_port_window_past_the_buffer_end_matches_jax_where_it_fits(scene, jax_window_fits):
    from dbaf_tpu_torch.utils import config as tconfig

    imu_rows, poses_at, gt_cw, gt_disps = scene
    cfg = _cfg(tconfig)
    cfg.buffer, cfg.ba.window = BUFFER, WINDOW
    h = PortHarness(cfg, gt_cw, gt_disps, imu_rows)
    got, ref = _run(h, poses_at), jax_window_fits
    assert h.graph.coupled.last_t0 + WINDOW > BUFFER  # the window ran past the buffer
    assert got["vi_key"] == ref["vi_key"] and got["vi_key"] is not None
    np.testing.assert_array_equal(got["stamps"], ref["stamps"])
    assert got["megas"] == ref["megas"] and got["megas"] >= 10
    np.testing.assert_allclose(got["est"], ref["est"], atol=3e-2)
    np.testing.assert_allclose(got["bs"], ref["bs"], atol=1e-4)
    _accuracy_asserts(got, gt_disps)


def test_reference_clamped_window_leaves_its_accuracy_bound(scene, jax_window_fits):
    """The reading behind ROADMAP Queue 3: the JAX package's clamped window
    solves on the wrong poses, so its run at the short buffer fails the
    accuracy bound that the same window meets where it fits."""
    from dbaf_tpu_torch.eval.ate import ate_rmse

    _accuracy_asserts(jax_window_fits, scene[3])
    clamped = _jax_run(scene, BUFFER)
    assert clamped["t1"] != jax_window_fits["t1"]  # other keyframes kept
    span = np.linalg.norm(clamped["ref"].max(0) - clamped["ref"].min(0))
    assert ate_rmse(clamped["est"], clamped["ref"], align="se3") > 0.08 * span
