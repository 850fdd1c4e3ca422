"""Analytic operation and byte counts of the work a run does, and the
chip's peaks.

The counts are the DROID network's and the correlation's at the published
widths, from the shapes alone: they read no kernel's name and no launch
counter, so they count the same work whatever implements it.  A
multiply-add is 2 operations.

* :func:`fnet_flops`, :func:`cnet_flops`: the encoders on one frame;
* :func:`update_flops`: the update operator on one edge;
* :func:`corr_volume_flops`: the all-pairs product of one edge,
  2 (H W)^2 C;
* :func:`corr_lookup_flops`: the separable tent contraction of one edge at
  4 levels, radius 3, for coordinates inside the image (``chip_smoke.py:
  355-389``'s count, the port at commit fc1ed8f, with no tap clipped);
* :func:`corr_bytes`: what one edge's correlation must read and write at
  least, each byte once: both feature maps in bfloat16, the coordinates in
  float32, the 196 output channels in bfloat16;
* :func:`least_seconds`: the larger of operations over the peak rate and
  bytes over the peak bandwidth (``chip_smoke.py:412-416``), and which bounds.
"""

from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

FNET_DIM, CNET_DIM, HIDDEN, CORR_CHANNELS, FEATURE_CHANNELS = 128, 256, 128, 196, 128
RADIUS, LEVELS = 3, 4


def conv_flops(cin: int, cout: int, k: int, pixels: int) -> float:
    return 2.0 * cin * cout * k * k * pixels


def encoder_flops(H: int, W: int, out_dim: int) -> float:
    """extractor.py's BasicEncoder at an H x W frame (stride 8 out)."""
    p2, p4, p8 = (H // 2) * (W // 2), (H // 4) * (W // 4), (H // 8) * (W // 8)
    f = conv_flops(3, 32, 7, p2)
    f += 4 * conv_flops(32, 32, 3, p2)                       # layer1: two blocks
    f += conv_flops(32, 64, 3, p4) + conv_flops(64, 64, 3, p4) + conv_flops(32, 64, 1, p4)
    f += 2 * conv_flops(64, 64, 3, p4)                       # layer2
    f += conv_flops(64, 128, 3, p8) + conv_flops(128, 128, 3, p8) + conv_flops(64, 128, 1, p8)
    f += 2 * conv_flops(128, 128, 3, p8)                     # layer3
    return f + conv_flops(128, out_dim, 1, p8)


def fnet_flops(H: int, W: int) -> float:
    return encoder_flops(H, W, FNET_DIM)


def cnet_flops(H: int, W: int) -> float:
    return encoder_flops(H, W, CNET_DIM)


def update_flops(H8: int, W8: int) -> float:
    """droid_net.py's UpdateModule on one edge of an H8 x W8 grid (the
    2-channel delta and weight heads)."""
    p = H8 * W8
    h, x = HIDDEN, HIDDEN + 128 + 64
    f = conv_flops(CORR_CHANNELS, 128, 1, p) + conv_flops(128, 128, 3, p)   # corr encoder
    f += conv_flops(4, 128, 7, p) + conv_flops(128, 64, 3, p)               # flow encoder
    f += conv_flops(h, h, 1, p)                                             # gru.w
    f += 3 * conv_flops(h + x, h, 3, p)                                     # convz/r/q
    f += 3 * conv_flops(h, h, 1, 1)                                         # *_glo
    f += 2 * conv_flops(h, 128, 3, p) + 2 * conv_flops(128, 2, 3, p)        # delta, weight
    return f


def corr_volume_flops(H8: int, W8: int, C: int = FEATURE_CHANNELS) -> float:
    P = H8 * W8
    return 2.0 * P * P * C


def corr_lookup_flops(H8: int, W8: int) -> float:
    """Per level l (stride s = 2^l), x first: 7 x taps of 2 s columns over
    the 8 s rows that the y taps reach, then 7 x 7 sums over 2 s rows."""
    per_pixel = 0.0
    for lvl in range(LEVELS):
        s = 2 ** lvl
        per_pixel += 7 * 2 * s * 8 * s + 49 * 2 * s
    return 2.0 * per_pixel * H8 * W8


def corr_flops(H8: int, W8: int) -> float:
    return corr_volume_flops(H8, W8) + corr_lookup_flops(H8, W8)


def corr_bytes(H8: int, W8: int, C: int = FEATURE_CHANNELS) -> float:
    P = H8 * W8
    return 2.0 * P * C * 2 + P * 2 * 4 + P * CORR_CHANNELS * 2


def gate_flops(H: int, W: int) -> float:
    """Every frame: fnet, the gate's correlation of one edge at the identity,
    one update step on it."""
    H8, W8 = H // 8, W // 8
    return fnet_flops(H, W) + corr_flops(H8, W8) + update_flops(H8, W8)


def edge_round_flops(H8: int, W8: int) -> float:
    return update_flops(H8, W8) + corr_flops(H8, W8)


def work_flops(H: int, W: int, frames: float, admitted: float, edge_rounds: float) -> float:
    """The network's and the correlation's operations for a span of work."""
    H8, W8 = H // 8, W // 8
    return (frames * gate_flops(H, W) + admitted * cnet_flops(H, W)
            + edge_rounds * edge_round_flops(H8, W8))


def least_seconds(flops: float, nbytes: float) -> Tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
