"""K1's wide path (``corr_fused_xy_kernel<false, true, *>``, 128 < W2 <= 256)
against its plain version, on the card, and K1 and K2 with whole-block
pooling (``whole=True``, KITTI-360's ragged 34 x 129 grid) against theirs.

Needs an NVIDIA GPU and ``nvcc``; skipped without a card (a CUDA kernel has
no CPU mode).  This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda -q -s tests/test_torch_k1_wide_cuda.py

Bound: ``atol 2e-2``, the one of K1's card test
(``tests/test_torch_kernels_cuda.py``): bf16 output, the volume summed on
the tensor cores in another order than the plain version, and here also a
row's x sums carried in two or three parts from chunk to chunk.  ``-s``
prints one E = 48 launch at KITTI-360's 34 x 129 grid and at the 40 x 112
grid of the whole-row kernel, timed with CUDA events over replays of a
CUDA graph (an eager launch loop would time the host).
"""

import re

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


def _kernel_names(fn, want="corr_fused_xy", tries=3):
    """The names of the CUDA kernels ``fn`` launched, from torch.profiler:
    the first of up to ``tries`` profiles that holds a name containing
    ``want`` (CUPTI at times hands a profile back with the runtime calls
    and no kernel records), else the last."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()}
        if any(want in n for n in names):
            break
    return names


def _graph_ms(fn, reps=20):
    """Card ms of one ``fn`` launch: a CUDA graph of it replayed ``reps``
    times between two events."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (48, 34, 129, 128, "noise"), (2, 9, 136, 128, "noise"), (2, 7, 200, 64, "noise"),
    (2, 5, 256, 128, "noise"), (3, 11, 129, 40, "noise"), (2, 34, 129, 128, "off_image"),
    (2, 34, 129, 128, "nan_row"),
], ids=["kitti360_e48", "w136", "w200_channels64", "w256", "w129_ragged_channels", "off_image",
        "nan_row"])
def test_corr_fused_xy_wide_matches_plain(dev, case):
    """The wide path against K1's plain version: KITTI-360's 34 x 129 grid
    at E = 48 (P = 4386 is no multiple of the block's 64 pixels, W2 = 129
    no multiple of 8: blocks of columns split between chunks), W2 = 136,
    200 and 256 (rows over two and three chunks), C = 64 and 40.
    Off-image coordinates give exactly 0; a NaN coordinate row 0 there and
    the plain values elsewhere."""
    from dbaf_tpu_torch.ops import corr_cuda as cc

    E, H, W, C, kind = case
    f1, f2, coords = _inputs(dev, E, H, W, C, 7)
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
@pytest.mark.parametrize("H,W,wide", [(40, 112, False), (48, 128, False), (34, 129, True),
                                      (16, 256, True)])
def test_k1_dispatch_by_width(dev, H, W, wide):
    """W2 <= 128 takes the whole-row kernel (``corr_fused_xy_kernel<kVec,
    false, false>``), as before the wide path existed; W2 > 128 the wide one
    (``<false, true, false>``).  Each prints its E = 48 launch's card ms
    where it is a preset's grid."""
    from dbaf_tpu_torch.ops import corr_cuda as cc

    E = 48 if (H, W) in ((40, 112), (34, 129)) else 2
    f1, f2, coords = _inputs(dev, E, H, W, 128, 3)
    f1p, f2p = cc.prepare_corr_fmaps(f1, f2)
    names = _kernel_names(lambda: cc.corr_fused_xy(f1p, f2p, coords, H, W))
    k1 = {n for n in names if "corr_fused_xy" in n}
    assert len(k1) == 1, names
    args = re.search(r"corr_fused_xy_kernel<(true|false), (true|false), false>", next(iter(k1)))
    assert args is not None and (args.group(2) == "true") == wide, k1
    if E == 48:
        ms = _graph_ms(lambda: cc.corr_fused_xy(f1p, f2p, coords, H, W))
        print(f"[k1-wide] E=48 {H}x{W}: {ms:.4f} ms ({next(iter(k1))}; "
              f"{torch.cuda.get_device_name(0)})")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,E,H,W", [
    ("k1", 48, 34, 129), ("k1", 2, 34, 120), ("k1", 2, 9, 17), ("k1", 2, 9, 200),
    ("k2", 1, 34, 129), ("k2", 2, 9, 17)],
    ids=["k1_wide_kitti360_e48", "k1_vec_34x120", "k1_9x17", "k1_wide_9x200", "k2_kitti360",
         "k2_9x17"])
def test_whole_blocks_match_plain(dev, kernel, E, H, W):
    """``whole=True`` on the card against the plain version with it, at
    grids 8 does not divide: K1's wide path, its whole-row kernel with
    vector block sums (W2 % 8 == 0, H2 ragged) and with element loads, and
    K2; at K1's and K2's card tolerances.  The whole-block result differs
    from the partial-block one there (the option reaches the kernel)."""
    from dbaf_tpu_torch.ops import corr as corr_ops
    from dbaf_tpu_torch.ops import corr_cuda as cc

    f1, f2, coords = _inputs(dev, E, H, W, 128, 11)
    if kernel == "k1":
        f1p, f2p = cc.prepare_corr_fmaps(f1, f2)
        got = cc.corr_fused_xy(f1p, f2p, coords, H, W, whole=True)
        torch.cuda.synchronize()
        want = cc.corr_fused_xy_plain(f1p, f2p, coords, H, W, whole=True)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)
        keep = cc.corr_fused_xy(f1p, f2p, coords, H, W)
    else:
        vol = corr_ops.build_volume_nhwc(f1.to(torch.bfloat16), f2.to(torch.bfloat16))
        got = cc.corr_lookup(vol, coords, whole=True)
        torch.cuda.synchronize()
        want = cc.corr_lookup_plain(vol, coords, whole=True)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        keep = cc.corr_lookup(vol, coords)
    assert (got.float() - keep.float()).abs().max() > 0.1


@pytest.mark.cuda
def test_int8_and_raw_keep_whole_rows(dev):
    """K1-int8 and K1-raw hold whole rows in a chunk: past 128 columns they
    raise before any launch."""
    from dbaf_tpu_torch.ops import corr_cuda as cc

    f1, f2, coords = _inputs(dev, 2, 8, 136, 128, 5)
    f1p, f2p = cc.prepare_corr_fmaps(f1, f2)
    with pytest.raises(ValueError, match="whole rows"):
        cc.corr_fused_xy(f1p, f2p, coords, 8, 136, raw=True)
    with pytest.raises(ValueError, match="whole rows"):
        cc.corr_fused_xy_int8(f1p, f2p, coords, 8, 136, 128)


@pytest.mark.cuda
def test_dbafusion_builds_at_kitti360_frames_on_the_card(dev):
    """The KITTI-360 preset at its stream's 272 x 1032 frames (a 34 x 129
    feature grid) builds on the card, and its first frame goes through."""
    import numpy as np

    from dbaf_tpu_torch.models.net import DroidNet
    from dbaf_tpu_torch.slam.system import DBAFusion
    from dbaf_tpu_torch.utils.config import kitti360_config

    cfg = kitti360_config()
    assert cfg.image_size == (272, 1032) and cfg.feat_size == (34, 129)
    torch.manual_seed(0)
    model = DroidNet(dtype=torch.bfloat16, device=dev, agg=False).eval()
    system = DBAFusion(cfg, device=dev, feat_fn=model.features_only,
                       ctx_fn=model.context_only, update_fn=model.update_fn)
    image = np.random.default_rng(0).integers(0, 255, (272, 1032, 3)).astype(np.float32)
    system.track(0.0, image, intrinsics=np.array([552.55, 552.55, 516.0, 136.0], np.float32))
    torch.cuda.synchronize()
    assert system.video.counter == 1
    assert tuple(system.video.fmaps.shape[-3:-1]) == (34, 129)
