"""The analytic counts against hand counts and against PyTorch's own FLOP
counter on the plain reference network; and that no count reads which
kernel ran."""

import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counts, harness
from perfbench.reference.droid import Droid


def test_dense_correlation_product_at_the_k1_shape():
    # E = 48 edges of a 48 x 64 grid, 128 channels: 2 (HW)^2 C per edge
    flops = 48 * counts.corr_volume_flops(48, 64)
    assert flops == pytest.approx(1.1597e11, rel=1e-4)
    least, by = counts.least_seconds(flops, 48 * counts.corr_bytes(48, 64))
    assert by == "operations"
    assert least * 1e3 == pytest.approx(0.1173, rel=1e-3)
    # with the tent lookup counted for interior coordinates (no tap clipped
    # at the border), within 1.5 % of chip_smoke's K1 bound of 0.1192 ms,
    # which clipped the taps of one round's coordinates
    total = 48 * counts.corr_flops(48, 64)
    assert total / counts.PEAK_BF16_FLOPS == pytest.approx(0.1192e-3, rel=0.015)


def test_lookup_count_by_hand():
    # level l, stride s: 7 x taps of 2s columns over 8s rows, 49 sums of 2s rows
    per_pixel = sum(7 * 2 * s * 8 * s + 49 * 2 * s for s in (1, 2, 4, 8))
    assert per_pixel == 9520 + 1470
    assert counts.corr_lookup_flops(48, 64) == 2 * per_pixel * 48 * 64


def _state_dict(seed=0):
    from perfbench import weights

    return weights.reference_state_dict(seed, torch.device("cpu"))


@pytest.mark.parametrize("what", ["fnet", "cnet", "update"])
def test_network_counts_match_pytorchs_flop_counter(what):
    net = Droid(_state_dict())
    H, W = 64, 128
    H8, W8 = H // 8, W // 8
    img = torch.rand(1, H, W, 3) * 255
    with FlopCounterMode(display=False) as fc:
        if what == "fnet":
            net.fnet(img)
        elif what == "cnet":
            net.cnet(img)
        else:
            E = 3
            net.update(torch.rand(E, H8, W8, 128), torch.rand(E, H8, W8, 128),
                       torch.rand(E, H8, W8, 196), torch.rand(E, H8, W8, 4))
    want = {"fnet": counts.fnet_flops(H, W), "cnet": counts.cnet_flops(H, W),
            "update": 3 * counts.update_flops(H8, W8)}[what]
    assert fc.get_total_flops() == pytest.approx(want, rel=1e-9)


def test_counts_read_no_kernel_or_launch_counter():
    here = os.path.join(harness.ROOT, "perfbench")
    for rel in ("counts.py", "metrics/step_mfu.py", "metrics/corr_roofline.py"):
        with open(os.path.join(here, rel)) as f:
            src = f.read()
        assert "LAUNCHES" not in src and "corr_cuda" not in src, rel
    with open(os.path.join(here, "counts.py")) as f:
        assert "kernels" not in f.read()
