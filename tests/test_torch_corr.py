"""Port parity for the correlation path: the plain versions of kernels K1
(``corr_fused_xy``) and K2 (``corr_lookup``) against the JAX package's
Pallas kernels in interpret mode, ``lookup_fused`` and ``lookup_pyramid``.

Tolerances:
* K1 vs ``corr_fused_xy_pallas``: the same bf16 rounding points, but the
  f32 sums run in another order and can flip a rounding, so ``atol`` is one
  bf16 ulp of the largest output (``2^-7 * max|out|``); against
  ``lookup_fused`` ``atol 2e-2``, the JAX test's bound (bf16 output,
  rounding at other points);
* K1-int8 vs ``corr_fused_xy_pallas(..., int8=True)``: the same integer
  x sums and rounding points; the f32 volume's sums run in another order,
  which can flip a bf16 rounding of P2 or of the output (one bf16 ulp of
  the largest output, ``2^-7 * max|out|``, the K1 bound; measured 3.9e-3
  of a max 1.59) or a quantized entry by one step, so
  ``corr_cuda.int8_agreement`` holds too: at most ``INT8_OFF_SHARE``
  (1e-3) of the outputs more than one bf16 ulp apart (measured 5.5e-5 and
  1.5e-5 at the two tiles), each within its per-output bound; the bf16
  lookup fails that check (0.38 of the outputs apart); against
  ``lookup_fused`` 2% of ``max|lookup_fused|``, the JAX test's int8 bound
  (test_corr.py:141-148);
* K1-raw vs ``corr_fused_xy_pallas(..., raw=True)``: all 1024 positions
  of each pixel's block within one bf16 ulp of the largest output
  (``2^-7 * max|out|``, the K1 bound); rows and columns 28-31 exactly 0;
  its diagonal blocks gathered by ``raw_corr_index`` exactly equal to the
  196-channel plain output (the same arithmetic in the same order), as
  ``test_corr.py:156-168`` holds the Pallas kernel's;
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
    q8 = tk.corr_fused_xy_int8(f1p, f2p, torch.tensor(co), 6, 8, 48)
    np.testing.assert_array_equal(
        q8.float().numpy(),
        tk.corr_fused_xy_int8_plain(f1p, f2p, torch.tensor(co), 6, 8, 48).float().numpy())
    assert all(n == 0 for n in tk.LAUNCHES.values()), tk.LAUNCHES


@pytest.mark.parametrize("tile,group", [(128, 8), (256, 16)])
def test_k1_int8_plain_matches_pallas_int8(tile, group):
    """test_corr.py:118-148's shape (E=2, 16x32, C=64: P=512, whole tiles
    of 128 and 256) through the port's int8 plain version and the Pallas
    kernel's int8 branch in interpret mode."""
    E, H, W, C = 2, 16, 32, 64
    f1, f2, co = _feats(10, E, H, W, C)
    j1, j2 = jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2, jnp.bfloat16)
    f1p, f2p = tk.prepare_corr_fmaps(torch.tensor(f1).bfloat16(), torch.tensor(f2).bfloat16())
    out = tk.corr_fused_xy_int8(f1p, f2p, torch.tensor(co), H, W, tile)
    assert out.shape == (E, H, W, 196) and out.dtype == torch.bfloat16
    out = out.float().numpy()
    ref = np.asarray(jc.lookup_fused(jc.build_volume_nhwc(j1, j2), jnp.asarray(co)))
    ref = ref.transpose(0, 2, 3, 1)
    pal = np.asarray(corr_fused_xy_pallas(j1, j2, jnp.asarray(co), tile=tile, group=group,
                                          interpret=True, int8=True)).astype(np.float32)
    np.testing.assert_allclose(out, ref, atol=0.02 * np.abs(ref).max())
    np.testing.assert_allclose(pal, ref, atol=0.02 * np.abs(ref).max())
    np.testing.assert_allclose(out, pal, atol=2 ** -7 * np.abs(pal).max())
    # the max pass's plain version is the tile's scale
    vmax = tk.corr_int8_vmax(f1p, f2p, H, W, tile)
    vol = np.einsum("epc,eqc->epq", f1p.float().numpy(), f2p.float().numpy())
    np.testing.assert_allclose(vmax.numpy(), np.abs(vol).reshape(E, -1, tile * H * W).max(-1),
                               rtol=1e-6)
    # nearly every output within one bf16 ulp of the Pallas kernel's; the
    # bf16 lookup (no quantization) on the same inputs is not
    agree = tk.int8_agreement(torch.tensor(out), torch.tensor(pal), vmax, tile)
    assert agree.ok, agree
    bf16 = tk.corr_fused_xy(f1p, f2p, torch.tensor(co), H, W)
    control = tk.int8_agreement(bf16, torch.tensor(pal), vmax, tile)
    assert not control.ok and control.off_share > 100 * tk.INT8_OFF_SHARE, control


def test_raw_corr_index_matches_the_jax_index():
    from dbaf_tpu.ops.corr_pallas import raw_corr_index

    np.testing.assert_array_equal(tk.raw_corr_index(), np.asarray(raw_corr_index()))
    assert tk.raw_corr_index().dtype == np.int32


@pytest.mark.parametrize("shape", [(2, 16, 32, 64), (2, 10, 12, 32)],
                         ids=["tiled", "ragged"])
def test_k1_raw_plain_matches_pallas_raw(shape):
    """The raw layout's plain version against the Pallas kernel's
    ``raw=True`` branch in interpret mode at test_corr.py's shape and the
    ragged one of the K1 test; its gather equals the 196-channel plain
    output exactly."""
    E, H, W, C = shape
    f1, f2, co = _feats(12, E, H, W, C)
    j1, j2 = jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2, jnp.bfloat16)
    f1p, f2p = tk.prepare_corr_fmaps(torch.tensor(f1).bfloat16(), torch.tensor(f2).bfloat16())
    tk.reset_launch_counts()
    out = tk.corr_fused_xy(f1p, f2p, torch.tensor(co), H, W, raw=True)
    assert out.shape == (E, H, W, 1024) and out.dtype == torch.bfloat16
    assert all(n == 0 for n in tk.LAUNCHES.values()), tk.LAUNCHES
    out = out.float().numpy()
    pal = np.asarray(corr_fused_xy_pallas(j1, j2, jnp.asarray(co), tile=_pallas_tile(H * W),
                                          group=8, interpret=True, raw=True)).astype(np.float32)
    assert pal.shape == out.shape
    np.testing.assert_allclose(out, pal, atol=2 ** -7 * np.abs(pal).max(), rtol=0)
    block = out.reshape(E, H, W, 32, 32)
    assert not block[..., 28:, :].any() and not block[..., :, 28:].any()
    assert np.abs(block[..., :7, 7:14]).max() > 0  # a cross-level block holds products
    idx = tk.raw_corr_index()
    pos = np.full(idx.max() + 1, -1, np.int64)
    pos[idx[idx >= 0]] = np.where(idx >= 0)[0]
    k1 = tk.corr_fused_xy_plain(f1p, f2p, torch.tensor(co), H, W).float().numpy()
    np.testing.assert_array_equal(out[..., pos], k1)


def _pallas_tile(P):
    """The Pallas tile of test_k1_plain_matches_pallas_and_lookup_fused:
    128, or the whole grid where it holds no multiple of 128."""
    return 128 if P % 128 == 0 else P


@pytest.mark.parametrize("h8,w8,group,tile", [
    (48, 64, 16, 256),   # tumvi_config: whole tiles of 16 * group
    (40, 112, 16, 128),  # kitti360_config: 4480 = 35 x 128, the group-8 fallback
    (10, 12, 16, None),  # 120 pixels: no whole tile, the bf16 lookup
    (48, 64, 3, None),   # 128 % 3: no whole group in a tile
])
def test_int8_tile_follows_corr_blk_layout(h8, w8, group, tile):
    """The JAX package's tile, where its Pallas path (and so int8) runs
    on a TPU; its backend check aside."""
    from dbaf_tpu.slam.graph import corr_blk_layout
    from dbaf_tpu.utils.config import DBAFusionConfig, GraphConfig

    _, jgroup, jtile = corr_blk_layout(DBAFusionConfig(graph=GraphConfig(corr_group=group)), h8, w8)
    tiles = (h8 * w8) % jtile == 0 and jtile % jgroup == 0
    assert tk.int8_tile(h8, w8, group) == tile == (jtile if tiles else None)



@pytest.mark.parametrize("preset", ["tumvi_config", "kitti360_config", "whu_config",
                                    "subt_config"])
def test_k1_takes_every_preset(preset):
    """Every preset's feature grid is within K1's limits (W2 <= 128, C = 128)."""
    from dbaf_tpu_torch.utils import config

    cfg = getattr(config, preset)()
    tk.check_k1_shape(cfg.feat_size[1], 128)


@pytest.mark.parametrize("W2,C", [(129, 128), (136, 128), (64, 192)],
                         ids=["w2_129", "w2_136", "c_192"])
def test_k1_shape_check_rejects_what_the_kernel_does_not_take(W2, C):
    with pytest.raises(ValueError, match="W2" if W2 > 128 else "channels"):
        tk.check_k1_shape(W2, C)


def test_dbafusion_refuses_a_grid_k1_does_not_take_at_construction():
    """An image wider than 1024 px raises when the system is built for the
    card, before any card is looked for, and is accepted on the CPU (the
    plain version takes any width)."""
    from dbaf_tpu_torch.slam.system import DBAFusion
    from dbaf_tpu_torch.utils import config

    cfg = config.tumvi_config(image_size=(384, 1088))
    with pytest.raises(ValueError, match="1088 px"):
        DBAFusion(cfg, device="cuda", feat_fn=lambda *a: None, ctx_fn=lambda *a: None,
                  update_fn=lambda *a: None)
    assert DBAFusion(cfg, device="cpu", feat_fn=lambda *a: None, ctx_fn=lambda *a: None,
                     update_fn=lambda *a: None).device.type == "cpu"
