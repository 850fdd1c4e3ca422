"""The port's synthetic oracle (``eval/synthetic.make_oracle``) against the
JAX package's, with and without ``noise_px``, on the same numpy inputs.

Without noise both return the same targets to f32 round-off (1e-4 px).  The
noise is a hash of the current reprojection and the edge: sines of phases
of order 1e5-1e8 rad, so an f32 ulp of a phase, or of a sine (the two
packages' sine implementations differ in the last bit on some arguments),
draws another value there.  Held: at least 95 % of the targets within 1e-4
px of the JAX ones (measured 98.9 %), none further apart than twice the
noise's bound (1.414 noise_px a coordinate), and the same spread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbaf_tpu.eval import synthetic as js
from dbaf_tpu_torch.eval import synthetic as ts


@pytest.mark.parametrize("noise_px", [0.0, 0.5])
def test_make_oracle_matches_jax(noise_px):
    rng = np.random.default_rng(0)
    N, H, W, E = 6, 8, 16, 5
    poses = np.tile(np.asarray([0, 0, 0, 0, 0, 0, 1], np.float32), (N, 1))
    poses[:, 0] = 0.1 * np.arange(N)
    disps = (0.3 + 0.1 * rng.random((N, H, W))).astype(np.float32)
    intr = np.asarray([16.0, 16.0, 8.0, 4.0], np.float32)
    ii, jj = rng.integers(0, N, E), rng.integers(0, N, E)
    coords1 = rng.uniform(0, 16, size=(E, H, W, 2)).astype(np.float32)
    net = np.zeros((E, H, W, 4), np.float32)
    _, jd, jw = js.make_oracle(poses, disps, intr, noise_px=noise_px)(
        jnp.asarray(net), None, None, None, jnp.asarray(ii, jnp.int32), jnp.asarray(jj, jnp.int32),
        {"id_map": jnp.arange(N, dtype=jnp.int32), "coords1": jnp.asarray(coords1)})
    _, td, tw = ts.make_oracle(poses, disps, intr, noise_px=noise_px)(
        torch.tensor(net), None, None, None, torch.tensor(ii), torch.tensor(jj),
        {"id_map": torch.arange(N), "coords1": torch.tensor(coords1)})
    jd, td = np.asarray(jd), td.numpy()
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    if not noise_px:
        np.testing.assert_allclose(td, jd, atol=1e-4)
        return
    diff = np.abs(td - jd)
    assert np.mean(diff <= 1e-4) >= 0.95, np.mean(diff <= 1e-4)
    assert diff.max() <= 2 * 1.414 * noise_px + 1e-4
    exact = ts.make_oracle(poses, disps, intr)(
        torch.tensor(net), None, None, None, torch.tensor(ii), torch.tensor(jj),
        {"id_map": torch.arange(N), "coords1": torch.tensor(coords1)})[1].numpy()
    noise_t, noise_j = td - exact, jd - exact
    assert np.abs(noise_t).max() <= 1.414 * noise_px + 1e-4
    np.testing.assert_allclose(noise_t.std(), noise_j.std(), rtol=0.05)
    assert 0.5 * noise_px < noise_t.std() < 1.5 * noise_px
