"""Plain correlation pyramid and windowed lookup, after DROID-SLAM's
``modules/corr.py`` (``CorrBlock``): the all-pairs volume
<f1/4, f2/4> over the feature channels, a 4-level average-pool pyramid over
the target pixels, and at each level a (2r+1)^2 window of bilinear samples
around the coordinates, zero outside the image.  Channel order as the
reference CUDA lookup writes it: level-major, then x offset, then y offset.

The volume is summed in float32 (the caller turns TF32 off).  A quantizer
``q`` rounds what a lower-precision pipeline stores: the features, the
volume and each pooled level, and the looked-up features; that is how the
control computes the same correlation in a lower precision.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

RADIUS = 3
LEVELS = 4


def pyramid(f1: torch.Tensor, f2: torch.Tensor,
            q: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> List[torch.Tensor]:
    """f1, f2: (E, H, W, C).  Returns the levels, each (E, H*W, H2/2^l, W2/2^l)."""
    E, H, W, C = f1.shape
    a, b = f1.float() / 4.0, f2.float() / 4.0
    if q is not None:
        a, b = q(a), q(b)
    vol = torch.einsum("epc,eqc->epq", a.reshape(E, H * W, C), b.reshape(E, -1, C))
    vol = vol.reshape(E * H * W, 1, f2.shape[1], f2.shape[2])
    levels = [vol]
    for _ in range(LEVELS - 1):
        levels.append(F.avg_pool2d(levels[-1], 2, stride=2))
    if q is not None:
        levels = [q(v) for v in levels]
    return [v.reshape(E, H * W, v.shape[-2], v.shape[-1]) for v in levels]


def _bilinear_window(vol: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """vol (E, P, h, w), x/y (E, P) at this level's scale.  Returns
    (E, P, 2r+1, 2r+1) with [a, b] the sample at (x + a - r, y + b - r)."""
    E, P, h, w = vol.shape
    R = 2 * RADIUS + 1
    off = torch.arange(R, device=vol.device, dtype=x.dtype) - RADIUS
    xs = x[..., None, None] + off[:, None]          # (E, P, a, 1)
    ys = y[..., None, None] + off[None, :]          # (E, P, 1, b)
    xs, ys = xs.expand(E, P, R, R), ys.expand(E, P, R, R)
    x0, y0 = torch.floor(xs), torch.floor(ys)
    flat = vol.reshape(E, P, h * w)
    out = torch.zeros((E, P, R, R), device=vol.device, dtype=torch.float32)
    for dx in (0, 1):
        for dy in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            wgt = (1 - torch.abs(xs - xi)) * (1 - torch.abs(ys - yi))
            inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long().reshape(E, P, R * R)
            val = torch.gather(flat, 2, idx).reshape(E, P, R, R)
            out = out + torch.where(inside, wgt * val, torch.zeros((), device=vol.device))
    return out


def lookup(levels: List[torch.Tensor], coords: torch.Tensor,
           q: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """coords (E, H, W, 2) (x, y) at level-0 scale.  Returns (E, H, W, 196)."""
    E, H, W, _ = coords.shape
    flat = coords.reshape(E, H * W, 2).float()
    outs = []
    for lvl, vol in enumerate(levels):
        s = 2.0 ** lvl
        outs.append(_bilinear_window(vol, flat[..., 0] / s, flat[..., 1] / s)
                    .reshape(E, H * W, -1))
    out = torch.cat(outs, dim=-1).reshape(E, H, W, -1)
    return out if q is None else q(out)
