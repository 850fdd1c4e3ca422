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
import torch.nn.functional as F

DEFAULT_RADIUS = 3
DEFAULT_LEVELS = 4


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round an f32 tensor to ``dtype`` and return it as f32."""
    return x.to(dtype).float()


def build_volume(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """All-pairs volume <fmap1/4, fmap2/4> from channels-first features
    (E, C, H, W); returns (E, H*W, H, W) in fmap1's dtype, summed in f32."""
    return build_volume_nhwc(fmap1.permute(0, 2, 3, 1), fmap2.permute(0, 2, 3, 1))


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


def build_pyramid_fast(volume: torch.Tensor,
                       num_levels: int = DEFAULT_LEVELS) -> List[torch.Tensor]:
    """:func:`build_pyramid` as the mean of the four strided 2x2 taps."""
    pyramid = [volume]
    v = volume
    for _ in range(num_levels - 1):
        v = 0.25 * (v[:, :, 0::2, 0::2] + v[:, :, 0::2, 1::2]
                    + v[:, :, 1::2, 0::2] + v[:, :, 1::2, 1::2])
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


def lookup_level_gather(volume: torch.Tensor, coords: torch.Tensor,
                        radius: int = DEFAULT_RADIUS) -> torch.Tensor:
    """:func:`lookup_level` by gathering the four integer-shifted taps of
    each window position, out-of-image taps 0 (correlation_kernels.cu:19-70).
    Returns (E, P, (2r+1)^2) f32."""
    E, P, H2, W2 = volume.shape
    R = 2 * radius + 1
    x0, y0 = coords[..., 0], coords[..., 1]
    fx, fy = torch.floor(x0), torch.floor(y0)
    dx = (x0 - fx)[..., None, None]
    dy = (y0 - fy)[..., None, None]
    offs = torch.arange(R, dtype=coords.dtype, device=coords.device) - radius
    xi = (fx[..., None, None] + offs[:, None]).expand(x0.shape + (R, R))
    yi = (fy[..., None, None] + offs[None, :]).expand(y0.shape + (R, R))
    vol_flat = volume.reshape(E, P, H2 * W2)

    def tap(ddx, ddy):
        xq, yq = xi + ddx, yi + ddy
        inb = (xq >= 0) & (xq < W2) & (yq >= 0) & (yq < H2)
        idx = (torch.clamp(yq, 0, H2 - 1).long() * W2 + torch.clamp(xq, 0, W2 - 1).long())
        vals = torch.gather(vol_flat, 2, idx.reshape(E, P, R * R)).reshape(E, P, R, R)
        return torch.where(inb, vals.float(), torch.zeros((), device=volume.device))

    out = ((1 - dx) * (1 - dy) * tap(0, 0) + dx * (1 - dy) * tap(1, 0)
           + (1 - dx) * dy * tap(0, 1) + dx * dy * tap(1, 1))
    return out.reshape(E, P, R * R).float()


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


def lookup_crop(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                radius: int = DEFAULT_RADIUS) -> torch.Tensor:
    """:func:`lookup_pyramid` from integer-window crops: the 2r+2 rows, then
    the 2r+2 columns of each window, and a 4-tap bilinear combine."""
    E, H, W, _ = coords.shape
    P = H * W
    R = 2 * radius + 1
    flat = coords.reshape(E, P, 2)
    outs = []
    for lvl, vol in enumerate(pyramid):
        H2, W2 = vol.shape[2], vol.shape[3]
        c = flat / (2.0 ** lvl)
        fx, fy = torch.floor(c[..., 0]), torch.floor(c[..., 1])
        dx = (c[..., 0] - fx)[..., None, None]
        dy = (c[..., 1] - fy)[..., None, None]
        offs = torch.arange(R + 1, dtype=fy.dtype, device=fy.device) - radius
        ry, rx = fy[..., None] + offs, fx[..., None] + offs
        my, mx = (ry >= 0) & (ry < H2), (rx >= 0) & (rx < W2)
        iy = torch.clamp(ry, 0, H2 - 1).long()
        ix = torch.clamp(rx, 0, W2 - 1).long()
        strip = torch.gather(vol, 2, iy[..., None].expand(E, P, R + 1, W2))
        win = torch.gather(strip, 3, ix[:, :, None, :].expand(E, P, R + 1, R + 1)).float()
        win = win * my[..., None] * mx[..., None, :]
        # (y = row, x = column); channel a * R + b with a the x offset
        out = ((1 - dy) * (1 - dx) * win[:, :, :R, :R] + (1 - dy) * dx * win[:, :, :R, 1:]
               + dy * (1 - dx) * win[:, :, 1:, :R] + dy * dx * win[:, :, 1:, 1:])
        outs.append(out.transpose(2, 3).reshape(E, P, R * R))
    out = torch.cat(outs, dim=-1)
    return out.permute(0, 2, 1).reshape(E, -1, H, W)


def pooled_tri_kernel(coord: torch.Tensor, size: int, radius: int, level: int,
                      whole: bool = False) -> torch.Tensor:
    """Level-``level`` tent weights against the level-0 grid,
    ``tri(floor(h/2^l) - (coord/2^l - r + k)) / 2^l`` (the average-pool
    pyramid folded into the weights).  Where 2^l does not divide ``size``
    the level's last cell pools the partial block, as the JAX package
    does; ``whole``: only the whole blocks, cells h < (size >> l) << l, as
    DROID-SLAM's ``CorrBlock`` pyramid (``F.avg_pool2d``) does.
    Returns (..., 2r+1, size)."""
    scale = float(2 ** level)
    offs = torch.arange(2 * radius + 1, dtype=coord.dtype, device=coord.device) - radius
    taps = coord[..., None, None] / scale + offs[:, None]
    cells = torch.arange(size, dtype=coord.dtype, device=coord.device)
    kern = torch.clamp(1.0 - torch.abs(torch.floor(cells / scale) - taps), min=0.0) / scale
    return kern * (cells < (size >> level) << level) if whole else kern


def lookup_fused(volume: torch.Tensor, coords: torch.Tensor, radius: int = DEFAULT_RADIUS,
                 num_levels: int = DEFAULT_LEVELS, whole: bool = False) -> torch.Tensor:
    """Multi-level lookup straight from the level-0 volume, y contracted
    first (the plain version of kernel K2).

    volume: (E, P, H2, W2) in any float dtype; coords: (E, H, W, 2), P == H*W.
    Returns (E, L*(2r+1)^2, H, W) f32.  Tents and the y-contracted
    intermediate are rounded to the volume's dtype, as ``lookup_fused`` and
    ``lookup_pallas`` do in the JAX package.  ``whole``: the levels pool
    whole blocks only (:func:`pooled_tri_kernel`).
    """
    E, P, H2, W2 = volume.shape
    _, H, W, _ = coords.shape
    R = 2 * radius + 1
    dt = volume.dtype
    flat = coords.reshape(E, P, 2).float()
    vol = volume.float()
    outs = []
    for lvl in range(num_levels):
        ky = _round(pooled_tri_kernel(flat[..., 1], H2, radius, lvl, whole), dt)
        kx = _round(pooled_tri_kernel(flat[..., 0], W2, radius, lvl, whole), dt)
        tmp = _round(torch.einsum("epbh,ephw->epbw", ky, vol), dt)
        outs.append(torch.einsum("epaw,epbw->epab", kx, tmp).reshape(E, P, R * R))
    out = torch.cat(outs, dim=-1)
    return out.permute(0, 2, 1).reshape(E, num_levels * R * R, H, W)


def lookup_fused_tiled(fmap1: torch.Tensor, fmap2: torch.Tensor, coords: torch.Tensor,
                       radius: int = DEFAULT_RADIUS, num_levels: int = DEFAULT_LEVELS,
                       tile: int = 512) -> torch.Tensor:
    """:func:`lookup_fused` of the volume of channels-last ``fmap1``,
    ``fmap2`` (E, H, W, C), built ``tile`` source pixels at a time and
    never whole (the reference's altcorr, modules/corr.py:91-139).
    Returns (E, L*(2r+1)^2, H, W) f32."""
    E, H, W, C = fmap1.shape
    P = H * W
    n_tiles = -(-P // tile)
    pad = n_tiles * tile - P
    f1 = F.pad(fmap1.reshape(E, P, C), (0, 0, 0, pad))
    flat = F.pad(coords.reshape(E, P, 2), (0, 0, 0, pad))
    f2 = (fmap2.reshape(E, P, C) / 4.0).float()
    outs = []
    for k in range(n_tiles):
        rows = slice(k * tile, (k + 1) * tile)
        vol = torch.bmm((f1[:, rows] / 4.0).float(), f2.transpose(1, 2)).to(fmap1.dtype)
        out = lookup_fused(vol.reshape(E, tile, H, W), flat[:, rows].reshape(E, tile, 1, 2),
                           radius, num_levels)
        outs.append(out.reshape(E, -1, tile))
    return torch.cat(outs, dim=-1)[..., :P].reshape(E, -1, H, W)


def projmap(poses, disps, intrinsics, ii, jj):
    """Dense reprojection coordinates and validity (the reference's
    ``droid_backends.projmap``, droid_kernels.cu:471-560)."""
    from . import projective

    return projective.projective_transform(poses, disps, intrinsics, ii, jj)


class CorrPyramid:
    """A correlation pyramid of a fixed edge set, looked up at given
    coordinates (the reference's ``CorrBlock``, modules/corr.py:23-60).
    fmap1, fmap2: (E, C, H, W)."""

    def __init__(self, fmap1: torch.Tensor, fmap2: torch.Tensor,
                 num_levels: int = DEFAULT_LEVELS, radius: int = DEFAULT_RADIUS):
        self.num_levels = num_levels
        self.radius = radius
        self.pyramid = build_pyramid(build_volume(fmap1, fmap2), num_levels)

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        return lookup_pyramid(self.pyramid, coords, self.radius)
