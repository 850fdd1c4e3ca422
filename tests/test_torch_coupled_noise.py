"""How far the JAX package's own coupled trajectory moves under input noise.

The end-to-end parity bound of ``test_torch_coupled.py`` (body positions to
``atol 3e-2`` m) is set by this reading, not by the port.  The same 26-frame
scenario runs twice through the JAX package, once with the oracle's
disparities perturbed by 1e-6 (relative, seeded).  The keyframes and the
VI-initialization point stay the same, but the VI alignment and the coupled
solve amplify the perturbation: the positions moved by 1.19e-2 m (span
2.3 m) and the biases by 9.5e-6, in f32 on the CPU.  So the reference cannot
meet a 1e-3 m bound against itself, and the port is held to the scale of
the reference's own noise.
"""

import jax.numpy as jnp
import numpy as np

from tests.test_slam_multisensor import MsHarness
from tests.test_torch_coupled import INTR, _cfg, _run, _scene


def _jax_run(scene, gt_disps):
    from dbaf_tpu.utils import config as jconfig

    imu_rows, poses_at, gt_cw, _ = scene
    h = MsHarness(_cfg(jconfig), jnp.asarray(gt_cw), jnp.asarray(gt_disps), INTR, imu_rows)
    return _run(h, poses_at)


def test_reference_positions_move_more_than_the_aim_under_input_noise():
    scene = _scene()
    gt_disps = scene[3]
    rng = np.random.default_rng(0)
    noisy = (gt_disps * (1 + 1e-6 * rng.standard_normal(gt_disps.shape))).astype(np.float32)
    base, moved = _jax_run(scene, gt_disps), _jax_run(scene, noisy)
    assert moved["vi_key"] == base["vi_key"] and moved["megas"] == base["megas"]
    np.testing.assert_array_equal(moved["stamps"], base["stamps"])
    shift = np.abs(moved["est"] - base["est"]).max()
    # well past the 1e-3 m aim, and inside the parity bound
    assert 3e-3 < shift < 3e-2, shift
