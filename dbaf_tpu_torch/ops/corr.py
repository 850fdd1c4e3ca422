"""Correlation volume: all-pairs build, pyramid, windowed lookup (PyTorch).

Port of ``dbaf_tpu/ops/corr.py``.  The functions here are the plain
versions; the hand-written kernels live in :mod:`.corr_cuda`, whose
``corr_lookup`` is the device dispatch that replaces ``lookup_auto`` (a
CUDA volume launches kernel K2, a CPU volume takes :func:`lookup_fused`).  The lookup
output follows the reference channel order: level-major, then
x-offset-major / y-offset-minor within a level
(correlation_kernels.cu:47-66), so converted DROID weights consume it
unchanged.

Precision mirrors the JAX functions: products of the stored dtype's values
are summed in f32 and rounded back to the stored dtype wherever the JAX
code casts (``preferred_element_type=f32`` followed by ``astype``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

DEFAULT_RADIUS = 3
DEFAULT_LEVELS = 4


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round an f32 tensor to ``dtype`` and return it as f32."""
    return x.to(dtype).float()


def build_volume_nhwc(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """All-pairs volume <fmap1/4, fmap2/4> from channels-last features.

    fmap1, fmap2: (E, H, W, C).  Returns (E, H*W, H, W) in fmap1's dtype
    (modules/corr.py:63-71), summed in f32.
    """
    E, H, W, C = fmap1.shape
    a = (fmap1.reshape(E, H * W, C) / 4.0).float()
    b = (fmap2.reshape(E, H * W, C) / 4.0).float()
    vol = torch.bmm(a, b.transpose(1, 2))
    return vol.reshape(E, H * W, H, W).to(fmap1.dtype)


def build_pyramid(volume: torch.Tensor, num_levels: int = DEFAULT_LEVELS) -> List[torch.Tensor]:
    """Average-pool pyramid over the target dims: (E, P, H2/2^l, W2/2^l)."""
    pyramid = [volume]
    v = volume
    for _ in range(num_levels - 1):
        E, P, H2, W2 = v.shape
        v = v.reshape(E, P, H2 // 2, 2, W2 // 2, 2).mean(dim=(3, 5))
        pyramid.append(v)
    return pyramid


def _tri_kernel(coord: torch.Tensor, size: int, radius: int) -> torch.Tensor:
    """(..., 2r+1, size) bilinear weights for samples ``coord - r + k``."""
    offs = torch.arange(2 * radius + 1, dtype=coord.dtype, device=coord.device) - radius
    taps = coord[..., None, None] + offs[:, None]
    grid = torch.arange(size, dtype=coord.dtype, device=coord.device)
    return torch.clamp(1.0 - torch.abs(grid - taps), min=0.0)


def lookup_level(volume: torch.Tensor, coords: torch.Tensor, radius: int = DEFAULT_RADIUS) -> torch.Tensor:
    """Windowed bilinear lookup at one pyramid level.

    volume: (E, P, H2, W2); coords: (E, P, 2) (x, y) at this level's scale.
    Returns (E, P, (2r+1)^2) f32, channel = a*(2r+1)+b with a the x offset.
    """
    E, P, H2, W2 = volume.shape
    dt = volume.dtype
    ky = _round(_tri_kernel(coords[..., 1], H2, radius), dt)
    kx = _round(_tri_kernel(coords[..., 0], W2, radius), dt)
    tmp = _round(torch.einsum("eprh,ephw->eprw", ky, volume.float()), dt)
    out = torch.einsum("epaw,epbw->epab", kx, tmp)
    R = 2 * radius + 1
    return out.reshape(E, P, R * R)


def lookup_pyramid(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                   radius: int = DEFAULT_RADIUS) -> torch.Tensor:
    """Multi-level lookup over an explicit pyramid (the channel-order
    oracle).  coords: (E, H, W, 2) at level-0 scale.  Returns
    (E, L*(2r+1)^2, H, W)."""
    E, H, W, _ = coords.shape
    flat = coords.reshape(E, H * W, 2)
    outs = [lookup_level(vol, flat / (2.0 ** lvl), radius) for lvl, vol in enumerate(pyramid)]
    out = torch.cat(outs, dim=-1)
    return out.permute(0, 2, 1).reshape(E, -1, H, W)


def pooled_tri_kernel(coord: torch.Tensor, size: int, radius: int, level: int) -> torch.Tensor:
    """Level-``level`` tent weights against the level-0 grid,
    ``tri(floor(h/2^l) - (coord/2^l - r + k)) / 2^l`` (the average-pool
    pyramid folded into the weights).  Returns (..., 2r+1, size)."""
    scale = float(2 ** level)
    offs = torch.arange(2 * radius + 1, dtype=coord.dtype, device=coord.device) - radius
    taps = coord[..., None, None] / scale + offs[:, None]
    grid = torch.floor(torch.arange(size, dtype=coord.dtype, device=coord.device) / scale)
    return torch.clamp(1.0 - torch.abs(grid - taps), min=0.0) / scale


def lookup_fused(volume: torch.Tensor, coords: torch.Tensor, radius: int = DEFAULT_RADIUS,
                 num_levels: int = DEFAULT_LEVELS) -> torch.Tensor:
    """Multi-level lookup straight from the level-0 volume, y contracted
    first (the plain version of kernel K2).

    volume: (E, P, H2, W2) in any float dtype; coords: (E, H, W, 2), P == H*W.
    Returns (E, L*(2r+1)^2, H, W) f32.  Tents and the y-contracted
    intermediate are rounded to the volume's dtype, as ``lookup_fused`` and
    ``lookup_pallas`` do in the JAX package.
    """
    E, P, H2, W2 = volume.shape
    _, H, W, _ = coords.shape
    R = 2 * radius + 1
    dt = volume.dtype
    flat = coords.reshape(E, P, 2).float()
    vol = volume.float()
    outs = []
    for lvl in range(num_levels):
        ky = _round(pooled_tri_kernel(flat[..., 1], H2, radius, lvl), dt)
        kx = _round(pooled_tri_kernel(flat[..., 0], W2, radius, lvl), dt)
        tmp = _round(torch.einsum("epbh,ephw->epbw", ky, vol), dt)
        outs.append(torch.einsum("epaw,epbw->epab", kx, tmp).reshape(E, P, R * R))
    out = torch.cat(outs, dim=-1)
    return out.permute(0, 2, 1).reshape(E, num_levels * R * R, H, W)
