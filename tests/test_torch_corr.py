"""Port parity for the correlation path: the plain versions of kernels K1
(``corr_fused_xy``) and K2 (``corr_lookup``) against the JAX package's
Pallas kernels in interpret mode, ``lookup_fused`` and ``lookup_pyramid``.

Tolerances:
* K1 vs ``corr_fused_xy_pallas``: the same bf16 rounding points, but the
  f32 sums run in another order and can flip a rounding, so ``atol`` is one
  bf16 ulp of the largest output (``2^-7 * max|out|``); against
  ``lookup_fused`` ``atol 2e-2``, the JAX test's bound (bf16 output,
  rounding at other points);
* K2 vs ``lookup_pallas``: f32 volumes ``atol 1e-4`` (the JAX test's bound);
  bf16 volumes ``atol 1e-2 * max|out|``: both sides round the tents and the
  y-contracted intermediate to bf16 (corr_pallas.py:66-67,75), so one
  flipped rounding of the intermediate moves an output by a bf16 ulp
  (2^-8 relative) of a partial sum no larger than max|out|.

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbaf_tpu.ops import corr as jc
from dbaf_tpu.ops.corr_pallas import corr_fused_xy_pallas, lookup_pallas
from dbaf_tpu_torch.ops import corr as tc
from dbaf_tpu_torch.ops import corr_cuda as tk


def _feats(seed, E, H, W, C):
    rng = np.random.default_rng(seed)
    f1 = rng.normal(size=(E, H, W, C)).astype(np.float32)
    f2 = rng.normal(size=(E, H, W, C)).astype(np.float32)
    co = np.stack([rng.uniform(-2.0, W + 2.0, size=(E, H, W)),
                   rng.uniform(-2.0, H + 2.0, size=(E, H, W))], -1).astype(np.float32)
    return f1, f2, co


@pytest.mark.parametrize("shape", [(2, 16, 32, 64), (2, 10, 12, 32)],
                         ids=["tiled", "ragged"])
def test_k1_plain_matches_pallas_and_lookup_fused(shape):
    """(2,16,32,64) is test_corr.py's shape; (2,10,12,32) has P=120 (not a
    multiple of 128, one Pallas tile of 120) and H2, W2 not divisible by 8."""
    E, H, W, C = shape
    f1, f2, co = _feats(10, E, H, W, C)
    j1, j2 = jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2, jnp.bfloat16)
    t1, t2 = torch.tensor(f1).bfloat16(), torch.tensor(f2).bfloat16()
    f1p, f2p = tk.prepare_corr_fmaps(t1, t2)
    out = tk.corr_fused_xy(f1p, f2p, torch.tensor(co), H, W)
    assert out.shape == (E, H, W, 196) and out.dtype == torch.bfloat16
    out = out.float().numpy()

    vol = jc.build_volume_nhwc(j1, j2)
    ref = np.asarray(jc.lookup_fused(vol, jnp.asarray(co))).transpose(0, 2, 3, 1)
    np.testing.assert_allclose(out, ref, atol=2e-2)

    tile = 128 if (H * W) % 128 == 0 else H * W  # the Pallas grid tiles P
    pal = corr_fused_xy_pallas(j1, j2, jnp.asarray(co), tile=tile, group=8,
                               interpret=True)
    pal = np.asarray(pal).astype(np.float32)
    np.testing.assert_allclose(out, pal, atol=2 ** -7 * np.abs(pal).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_plain_matches_lookup_pallas(dtype):
    E, H, W, C = 2, 8, 16, 32
    f1, f2, co = _feats(11, E, H, W, C)
    jvol = jc.build_volume_nhwc(jnp.asarray(f1), jnp.asarray(f2)).astype(dtype)
    tvol = torch.tensor(np.asarray(jvol.astype(jnp.float32))).to(getattr(torch, dtype))
    ref = np.asarray(lookup_pallas(jvol, jnp.asarray(co), tile=64, interpret=True))
    out = tk.corr_lookup(tvol, torch.tensor(co))
    assert out.shape == (E, 196, H, W) and out.dtype == torch.float32
    out = out.numpy()
    atol = 1e-4 if dtype == "float32" else 1e-2 * np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=atol)
    np.testing.assert_allclose(
        out, np.asarray(jc.lookup_fused(jvol, jnp.asarray(co))), atol=atol)


def test_volume_build_matches():
    f1, f2, _ = _feats(12, 2, 6, 8, 32)
    for dt in ("float32", "bfloat16"):
        j = jc.build_volume_nhwc(jnp.asarray(f1, dt), jnp.asarray(f2, dt))
        t = tc.build_volume_nhwc(torch.tensor(f1).to(getattr(torch, dt)),
                                 torch.tensor(f2).to(getattr(torch, dt)))
        assert t.dtype == getattr(torch, dt)
        # bf16: one rounding of an f32 sum, summed in another order
        atol = 1e-5 if dt == "float32" else 2 ** -8 * np.abs(np.asarray(j, np.float32)).max()
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=atol)


def test_channel_order_matches_lookup_pyramid():
    """The fused lookups keep lookup_pyramid's reference channel order
    (level-major, x-offset-major) where the pooled pyramid is exact
    (H2, W2 divisible by 8)."""
    rng = np.random.default_rng(13)
    E, H, W = 1, 8, 16
    vol = rng.normal(size=(E, H * W, H, W)).astype(np.float32)
    co = np.stack([rng.uniform(0, W - 1, size=(E, H, W)),
                   rng.uniform(0, H - 1, size=(E, H, W))], -1).astype(np.float32)
    pyr_j = jc.build_pyramid(jnp.asarray(vol))
    ref = np.asarray(jc.lookup_pyramid(pyr_j, jnp.asarray(co)))
    pyr_t = tc.build_pyramid(torch.tensor(vol))
    got_pyr = tc.lookup_pyramid(pyr_t, torch.tensor(co)).numpy()
    got_fused = tc.lookup_fused(torch.tensor(vol), torch.tensor(co)).numpy()
    np.testing.assert_allclose(got_pyr, ref, atol=1e-4)
    np.testing.assert_allclose(got_fused, ref, atol=1e-4)
    # center tap of level 0 (a = b = 3 -> channel 24) at integer coords
    ci = np.floor(co).astype(np.float32)
    center = tc.lookup_fused(torch.tensor(vol), torch.tensor(ci)).numpy()[0, 24]
    p = np.arange(H * W)
    want = vol[0, p, ci[0, ..., 1].reshape(-1).astype(int), ci[0, ..., 0].reshape(-1).astype(int)]
    np.testing.assert_allclose(center.reshape(-1), want, atol=1e-5)


def test_dispatch_sends_cpu_tensors_to_plain_path():
    f1, f2, co = _feats(14, 1, 6, 8, 16)
    vol = tc.build_volume_nhwc(torch.tensor(f1).bfloat16(), torch.tensor(f2).bfloat16())
    tk.reset_launch_counts()
    got = tk.corr_lookup(vol, torch.tensor(co))
    np.testing.assert_array_equal(got.numpy(), tc.lookup_fused(vol, torch.tensor(co)).numpy())
    f1p, f2p = tk.prepare_corr_fmaps(torch.tensor(f1), torch.tensor(f2))
    k1 = tk.corr_fused_xy(f1p, f2p, torch.tensor(co), 6, 8)
    np.testing.assert_array_equal(
        k1.float().numpy(), tk.corr_fused_xy_plain(f1p, f2p, torch.tensor(co), 6, 8).float().numpy())
    assert tk.LAUNCHES == {"corr_fused_xy": 0, "corr_lookup": 0}
