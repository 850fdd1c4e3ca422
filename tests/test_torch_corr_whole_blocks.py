"""The correlation pyramid's whole-block pooling (``whole=True``,
``DBAFusionConfig.corr_whole_blocks``) in the plain versions of K1 and K2.

DROID-SLAM's ``CorrBlock`` builds its levels with ``avg_pool2d``, which
drops a level's partial block where 2^l does not divide the grid; the JAX
package's tents keep it.  With ``whole=True`` the port's lookups follow
the former: at a ragged grid (KITTI-360's 34 x 129, and 9 x 17) they meet
the benchmark's plain reference (``perfbench/reference/corr.py``, f32) as
closely as at a grid 8 divides, where the two poolings are the same
computation, bit for bit.  JAX-free.
"""

import pytest
import torch

from dbaf_tpu_torch.ops import corr as corr_ops
from dbaf_tpu_torch.ops import corr_cuda as cc
from perfbench.check import gap
from perfbench.reference import corr as rcorr


def _case(H, W, E=2, C=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    f1 = torch.randn(E, H, W, C, generator=g)
    f2 = torch.randn(E, H, W, C, generator=g)
    grid = torch.stack(torch.meshgrid(torch.arange(W), torch.arange(H), indexing="xy"), -1)
    coords = grid[None].float() + (torch.rand(E, H, W, 2, generator=g) - 0.5) * 16.0
    return f1, f2, coords.contiguous()


def _lookups(f1, f2, coords, whole):
    """(K1 plain, K2 plain), each (E, H, W, 196)."""
    _, H, W, _ = f1.shape
    f1p, f2p = cc.prepare_corr_fmaps(f1, f2)
    k1 = cc.corr_fused_xy_plain(f1p, f2p, coords, H, W, whole)
    vol = corr_ops.build_volume_nhwc(f1.to(torch.bfloat16), f2.to(torch.bfloat16))
    k2 = cc.corr_lookup_plain(vol, coords, whole).permute(0, 2, 3, 1)
    return k1, k2


@pytest.mark.parametrize("H,W", [(34, 129), (9, 17)], ids=["kitti360_34x129", "ragged_9x17"])
def test_whole_blocks_meet_droid_pyramid_at_ragged_grids(H, W):
    """Whole blocks: K1's and K2's plain versions within bf16 rounding of
    the reference (below 0.007, tumvi's and whu's ``k1_round`` limit);
    partial blocks: ten times further off, the gap this option closes."""
    f1, f2, coords = _case(H, W)
    ref = rcorr.lookup(rcorr.pyramid(f1, f2), coords)
    for name, got in zip(("k1", "k2"), _lookups(f1, f2, coords, True)):
        assert gap(got, ref) < 0.007, (name, gap(got, ref))
    for name, got in zip(("k1", "k2"), _lookups(f1, f2, coords, False)):
        assert gap(got, ref) > 0.04, (name, gap(got, ref))


def test_whole_blocks_change_nothing_where_8_divides_the_grid():
    f1, f2, coords = _case(16, 24)
    for a, b in zip(_lookups(f1, f2, coords, True), _lookups(f1, f2, coords, False)):
        assert torch.equal(a, b)


def test_pooled_tent_zero_past_the_whole_blocks():
    """Level 2 of 10 cells: whole blocks cover cells 0-7; cells 8 and 9
    (the partial block) weigh 0 with ``whole`` and as before without."""
    c = torch.tensor([[8.5]])
    keep = corr_ops.pooled_tri_kernel(c, 10, 3, 2)
    whole = corr_ops.pooled_tri_kernel(c, 10, 3, 2, whole=True)
    assert torch.equal(whole[..., :8], keep[..., :8])
    assert torch.count_nonzero(whole[..., 8:]) == 0 and torch.count_nonzero(keep[..., 8:]) > 0


def test_k1_raw_and_int8_refuse_whole_blocks():
    """K1-raw refuses ``whole``; ``DBAFusion`` refuses whole blocks where
    K1-int8 would run on a ragged grid, and takes them where the grid holds
    no whole int8 tile (the bf16 lookup runs, as the benchmark's control
    run of the KITTI-360 cell does)."""
    from dbaf_tpu_torch.slam.system import DBAFusion
    from dbaf_tpu_torch.utils.config import GraphConfig, kitti360_config

    f1, f2, coords = _case(4, 8, E=1)
    f1p, f2p = cc.prepare_corr_fmaps(f1, f2)
    with pytest.raises(ValueError, match="partial blocks"):
        cc.corr_fused_xy(f1p, f2p, coords, 4, 8, raw=True, whole=True)
    fns = dict(feat_fn=lambda x: x, ctx_fn=lambda x: x, update_fn=lambda *a: a)
    # 34 x 128 holds whole int8 tiles (256 pixels): K1-int8 would run
    cfg = kitti360_config(image_size=(272, 1024), graph=GraphConfig(corr_int8=True))
    with pytest.raises(ValueError, match="corr_whole_blocks"):
        DBAFusion(cfg, device="cpu", **fns)
    # at 34 x 129 it holds none, so the bf16 lookup runs, with whole blocks
    DBAFusion(kitti360_config(graph=GraphConfig(corr_int8=True)), device="cpu", **fns)
