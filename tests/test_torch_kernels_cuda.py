"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and ``nvcc``; skipped without a card (a CUDA kernel has
no CPU mode).  This file imports neither JAX nor the JAX package, so it runs
where only PyTorch is installed:

    python -m pytest --noconftest -m cuda -q tests/test_torch_kernels_cuda.py

Bounds: K1 ``atol 2e-2`` (bf16 output, test_corr.py's bound; the kernel sums
the volume on the tensor cores in another order than the plain version);
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
@pytest.mark.parametrize("shape", [(4, 48, 64, 128), (3, 10, 13, 128), (2, 37, 45, 40)],
                         ids=["main", "ragged", "ragged_channels"])
def test_corr_fused_xy_matches_plain(dev, shape):
    from dbaf_tpu_torch.ops import corr_cuda as cc

    E, H, W, C = shape
    f1, f2, coords = _inputs(dev, E, H, W, C, 1)
    f1p, f2p = cc.prepare_corr_fmaps(f1, f2)
    before = cc.LAUNCHES["corr_fused_xy"]
    got = cc.corr_fused_xy(f1p, f2p, coords, H, W)
    torch.cuda.synchronize()
    assert cc.LAUNCHES["corr_fused_xy"] == before + 1
    want = cc.corr_fused_xy_plain(f1p, f2p, coords, H, W)
    assert got.shape == want.shape == (E, H, W, 196) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 48, 64), (2, 11, 14)], ids=["main", "ragged"])
def test_corr_lookup_matches_plain(dev, dtype, shape):
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
