"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and ``nvcc``; skipped without a card (a CUDA kernel has
no CPU mode).  This file imports neither JAX nor the JAX package, so it runs
where only PyTorch is installed:

    python -m pytest --noconftest -m cuda -q tests/test_torch_kernels_cuda.py

Bounds: K1 ``atol 2e-2`` (bf16 output, test_corr.py's bound; the kernel sums
the volume on the tensor cores in another order than the plain version);
K1-int8 ``corr_cuda.int8_agreement``: at most ``INT8_OFF_SHARE`` of the
outputs more than one bf16 ulp apart (an f32 sum in another order flips the
rounding of a quantized entry only near a half step), each within one int8
quantum of its tile's scale per tap plus a bf16 ulp of P2 and of the
output, and K1 (bf16, no quantization) on the same inputs must fail it; its
max pass ``rtol 1e-4`` (f32 sums of bf16 products in another order);
K1-raw one bf16 ulp of its largest output, ``2^-7 * max|out|`` (the same
rounding points as its plain version, f32 sums in another order), rows and
columns 28-31 exactly 0;
K2 ``atol 1e-5`` for f32 and bf16 volumes (the kernel rounds tents and the
y-contracted intermediate where the plain version does, and the two differ
only in the order of f32 sums; a skipped bf16 rounding would show at about
2^-9 of the output).
"""

import pytest
import torch


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, E, H, W, C, seed):
    g = torch.Generator().manual_seed(seed)
    f1 = torch.randn(E, H, W, C, generator=g)
    f2 = torch.randn(E, H, W, C, generator=g)
    grid = torch.stack(torch.meshgrid(torch.arange(W), torch.arange(H), indexing="xy"), -1)
    coords = grid[None].float() + (torch.rand(E, H, W, 2, generator=g) - 0.5) * 16.0
    return f1.to(dev), f2.to(dev), coords.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (4, 48, 64, 128, "noise"), (3, 10, 13, 128, "noise"), (2, 37, 45, 40, "noise"),
    (1, 48, 64, 128, "noise"), (48, 48, 64, 128, "noise"), (2, 7, 45, 128, "noise"),
    (2, 40, 112, 128, "noise"), (2, 48, 64, 128, "off_image"), (2, 37, 45, 128, "nan_row"),
], ids=["main", "ragged", "ragged_channels", "one_edge", "e48", "p_not_multiple_of_block",
        "one_row_chunks", "off_image", "nan_row"])
def test_corr_fused_xy_matches_plain(dev, case):
    """K1 against its plain version.  P = 130 and 315 are not multiples of
    the block's 64 pixels, W2 = 13 and 45 not multiples of 8, W2 = 112 puts
    one row in a chunk.  Off-image coordinates give exactly 0; a NaN
    coordinate row gives 0 there (an empty support) and the plain values
    elsewhere."""
    from dbaf_tpu_torch.ops import corr_cuda as cc

    E, H, W, C, kind = case
    f1, f2, coords = _inputs(dev, E, H, W, C, 1)
    if kind == "off_image":
        coords = coords + torch.tensor([2.0 * W + 40.0, -2.0 * H - 40.0], device=dev)
    if kind == "nan_row":
        coords[:, H // 2] = float("nan")
    f1p, f2p = cc.prepare_corr_fmaps(f1, f2)
    before = cc.LAUNCHES["corr_fused_xy"]
    got = cc.corr_fused_xy(f1p, f2p, coords, H, W)
    torch.cuda.synchronize()
    assert cc.LAUNCHES["corr_fused_xy"] == before + 1
    want = cc.corr_fused_xy_plain(f1p, f2p, coords, H, W)
    assert got.shape == want.shape == (E, H, W, 196) and got.dtype == torch.bfloat16
    if kind == "off_image":
        assert torch.count_nonzero(got) == 0 and torch.count_nonzero(want) == 0
    if kind == "nan_row":
        assert torch.count_nonzero(got[:, H // 2]) == 0
        assert torch.isfinite(got).all()
        keep = torch.ones(H, dtype=torch.bool, device=dev)
        keep[H // 2] = False
        got, want = got[:, keep], want[:, keep]
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (48, 48, 64, 128, 256, "noise"), (4, 40, 48, 128, 128, "noise"),
    (4, 32, 60, 128, 128, "noise"), (2, 16, 32, 64, 128, "noise"),
    (2, 48, 64, 128, 256, "off_image"), (4, 32, 60, 128, 128, "nan_row"),
], ids=["main", "tile128", "tile128_ragged_rows", "channels64", "off_image", "nan_row"])
def test_corr_fused_xy_int8_matches_plain(dev, case):
    """K1-int8 and its max pass against their plain versions: tumvi's tile
    of 256, the group-8 tile of 128 (40 x 48 and 32 x 60 hold 15 of them;
    W2 = 60 is no multiple of 8), C = 64 (one TMA box); off-image
    coordinates give exactly 0, a NaN coordinate row 0 there.  K1 (bf16)
    on the noise cases' inputs is the control that the check can fail."""
    from dbaf_tpu_torch.ops import corr_cuda as cc

    E, H, W, C, tile, kind = case
    f1, f2, coords = _inputs(dev, E, H, W, C, 4)
    if kind == "off_image":
        coords = coords + torch.tensor([2.0 * W + 40.0, -2.0 * H - 40.0], device=dev)
    if kind == "nan_row":
        coords[:, H // 2] = float("nan")
    f1p, f2p = cc.prepare_corr_fmaps(f1, f2)
    vmax = cc.corr_int8_vmax(f1p, f2p, H, W, tile)
    before = dict(cc.LAUNCHES)
    got = cc.corr_fused_xy_int8(f1p, f2p, coords, H, W, tile)
    torch.cuda.synchronize()
    assert cc.LAUNCHES["corr_fused_xy_int8"] == before["corr_fused_xy_int8"] + 1
    assert cc.LAUNCHES["corr_int8_vmax"] == before["corr_int8_vmax"] + 1
    vmax_ref = cc.corr_int8_vmax_plain(f1p, f2p, tile)
    torch.testing.assert_close(vmax, vmax_ref, rtol=1e-4, atol=0)
    want = cc.corr_fused_xy_int8_plain(f1p, f2p, coords, H, W, tile)
    assert got.shape == want.shape == (E, H, W, 196) and got.dtype == torch.bfloat16
    if kind == "off_image":
        assert torch.count_nonzero(got) == 0 and torch.count_nonzero(want) == 0
    keep = None
    if kind == "nan_row":
        assert torch.count_nonzero(got[:, H // 2]) == 0
        assert torch.isfinite(got).all()
        keep = torch.arange(H, device=dev) != H // 2
    agree = cc.int8_agreement(got, want, vmax_ref, tile, keep)
    assert agree.ok, agree
    if kind == "noise":
        control = cc.int8_agreement(cc.corr_fused_xy(f1p, f2p, coords, H, W), want, vmax_ref,
                                    tile)
        assert not control.ok, control


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (48, 48, 64, 128, "noise"), (3, 10, 13, 128, "noise"), (2, 37, 45, 40, "noise"),
    (2, 40, 112, 128, "noise"), (2, 48, 64, 128, "off_image"), (2, 37, 45, 128, "nan_row"),
], ids=["e48", "ragged", "ragged_channels", "one_row_chunks", "off_image", "nan_row"])
def test_corr_fused_xy_raw_matches_plain(dev, case):
    """K1-raw against its plain version at the main shape, ragged pixel
    counts and widths (P = 130 and 1665 are no multiples of 64, W2 = 13
    and 45 no multiples of 8), one row per chunk; off the image exactly 0,
    a NaN coordinate row 0 there.  Its diagonal blocks gathered by
    raw_corr_index equal K1's output on the same inputs, up to the same
    one-ulp bound (the two kernels sum in different orders)."""
    from dbaf_tpu_torch.ops import corr_cuda as cc

    E, H, W, C, kind = case
    f1, f2, coords = _inputs(dev, E, H, W, C, 5)
    if kind == "off_image":
        coords = coords + torch.tensor([2.0 * W + 40.0, -2.0 * H - 40.0], device=dev)
    if kind == "nan_row":
        coords[:, H // 2] = float("nan")
    f1p, f2p = cc.prepare_corr_fmaps(f1, f2)
    before = cc.LAUNCHES["corr_fused_xy_raw"]
    got = cc.corr_fused_xy(f1p, f2p, coords, H, W, raw=True)
    torch.cuda.synchronize()
    assert cc.LAUNCHES["corr_fused_xy_raw"] == before + 1
    want = cc.corr_fused_xy_raw_plain(f1p, f2p, coords, H, W)
    assert got.shape == want.shape == (E, H, W, 1024) and got.dtype == torch.bfloat16
    block = got.reshape(E, H, W, 32, 32)
    assert torch.count_nonzero(block[..., 28:, :]) == 0
    assert torch.count_nonzero(block[..., :, 28:]) == 0
    k1 = cc.corr_fused_xy(f1p, f2p, coords, H, W)
    if kind == "off_image":
        assert torch.count_nonzero(got) == 0 and torch.count_nonzero(want) == 0
    if kind == "nan_row":
        assert torch.count_nonzero(got[:, H // 2]) == 0
        assert torch.isfinite(got).all()
        keep = torch.arange(H, device=dev) != H // 2
        got, want, k1 = got[:, keep], want[:, keep], k1[:, keep]
    tol = 2.0 ** -7 * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    idx = torch.as_tensor(cc.raw_corr_index(), device=dev).long()
    pos = torch.empty(196, dtype=torch.long, device=dev)
    live = torch.nonzero(idx >= 0)[:, 0]
    pos[idx[live]] = live
    torch.testing.assert_close(got[..., pos].float(), k1.float(), atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 48, 64), (2, 11, 14), (4, 48, 64), (3, 37, 45),
                                   (1, 128, 128)],
                         ids=["main", "ragged", "tail", "ragged_tail", "wide"])
def test_corr_lookup_matches_plain(dev, dtype, shape):
    """K2 against its plain version.  4 x 3072 pixels leave the persistent
    warps a ragged last round; 37 x 45 rows are not 16-byte multiples, so
    the rows come in by element loads; 128 x 128 rows are too long for four
    warps' buffers in a block (two warps a block in bf16, one in f32)."""
    from dbaf_tpu_torch.ops import corr as corr_ops
    from dbaf_tpu_torch.ops import corr_cuda as cc

    E, H, W = shape
    f1, f2, coords = _inputs(dev, E, H, W, 128, 2)
    vol = corr_ops.build_volume_nhwc(f1.to(dtype), f2.to(dtype))
    got = cc.corr_lookup(vol, coords)
    torch.cuda.synchronize()
    want = cc.corr_lookup_plain(vol, coords)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    from dbaf_tpu_torch.ops import corr_cuda as cc

    f1, f2, coords = _inputs(dev, 1, 6, 8, 32, 3)
    f1p, f2p = cc.prepare_corr_fmaps(f1, f2)
    with pytest.raises(ValueError):
        cc.corr_fused_xy(f1p.float(), f2p, coords, 6, 8)
    with pytest.raises(ValueError):
        cc.corr_fused_xy(f1p, f2p, coords.double(), 6, 8)
    vol = torch.zeros(1, 48, 6, 8, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        cc.corr_lookup(vol, coords)
    # K1 holds whole rows of f2 in a chunk: W2 <= 128
    f1, f2, coords = _inputs(dev, 1, 2, 136, 32, 3)
    f1p, f2p = cc.prepare_corr_fmaps(f1, f2)
    with pytest.raises(ValueError, match="W2=136"):
        cc.corr_fused_xy(f1p, f2p, coords, 2, 136)
    # K2 needs two f32 rows of 180 x 180 in one block: more than 227 KB
    vol = torch.zeros(1, 4, 180, 180, device=dev)
    with pytest.raises(RuntimeError, match="cudaError"):
        cc.corr_lookup(vol, torch.zeros(1, 2, 2, 2, device=dev))


def _frame(k: int, H: int, W: int):
    """A procedural textured frame (uint8), shifted with k."""
    import numpy as np

    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    img = np.stack([np.sin(fx * (x + 3.0 * k) + fy * (y + 1.5 * k) + ph) for fx, fy, ph in
                    ((0.31, 0.17, 0.0), (0.12, 0.41, 1.3), (0.23, 0.29, 2.1))], -1)
    return np.clip(127.5 + 90.0 * img, 0, 255).astype(np.uint8)


@pytest.mark.cuda
def test_visual_async_entry_points_on_the_card(dev):
    """``DBAFusion`` with ``async_pipeline`` on the card (64 x 128 frames,
    the seeded full-width network, rollup 14/4 and int8 correlation): five
    steady-state frames under ``set_sync_debug_mode("error")``, so no call
    of the step synchronises; K2 on every gated frame, K1-int8 in every
    round, and a finite trajectory."""
    import json
    import os

    import numpy as np

    from dbaf_tpu_torch.models.convert import load_reference_state_dict, synth_reference_state_dict
    from dbaf_tpu_torch.ops import corr_cuda as cc
    from dbaf_tpu_torch.slam.system import DBAFusion
    from dbaf_tpu_torch.utils import config

    H, W, n_frames = 64, 128, 16
    with open(os.path.join(os.path.dirname(__file__), "data", "droid_sd_manifest.json")) as f:
        manifest = json.load(f)
    params = load_reference_state_dict(synth_reference_state_dict(manifest, 20260820), manifest)
    cfg = config.DBAFusionConfig(
        image_size=(H, W), buffer=24,
        graph=config.GraphConfig(max_factors=32, edge_capacity=48, inactive_capacity=48,
                                 frontend_thresh=20.0, far_threshold=-1.0, corr_int8=True),
        frontend=config.FrontendConfig(warmup=8, keyframe_thresh=-1.0, filter_thresh=-1.0,
                                       iters1=2, iters2=1, init_iters=4, rollup_start=14,
                                       rollup_shift=4, async_pipeline=True),
        ba=config.BAConfig(window=20, iters=2))
    system = DBAFusion(cfg, params=params, device=dev)
    intr = np.asarray([70.0, 70.0, W / 2, H / 2], np.float32)
    cc.reset_launch_counts()
    a = system._async
    guarded = 0
    for k in range(n_frames):
        guard = a.active and guarded < 5
        if guard:
            torch.cuda.set_sync_debug_mode("error")
        try:
            system.track(float(k), _frame(k, H, W), intrinsics=intr)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        guarded += guard
    assert a.active and guarded == 5
    traj = system.terminate()
    fe = system.frontend
    assert a.stats()["steps"] == n_frames - 8 and fe.rollup_count >= 1
    assert cc.LAUNCHES["corr_lookup"] == n_frames - 1
    assert cc.LAUNCHES["corr_fused_xy_int8"] >= fe.update_rounds > 0
    assert cc.LAUNCHES["corr_fused_xy"] == 0
    assert traj.shape == (fe.keyframe_steps, 8) and np.all(np.isfinite(traj))
