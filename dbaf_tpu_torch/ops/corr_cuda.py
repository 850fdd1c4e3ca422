"""Hand-written CUDA kernels for the correlation lookups, with their wrappers,
launch counters and plain PyTorch versions.

K1 ``corr_fused_xy`` replaces the Pallas kernel ``_fused_xy_kernel``
(``dbaf_tpu/ops/corr_pallas.py:206``, driven by ``corr_fused_xy_prepared``):
the correlation rows are built in shared memory (``wgmma`` on TMA-fed
tiles) and contracted with the 4-level tent weights, x first, without ever
storing the volume.  It runs in every update round for every active edge.

K1-int8 ``corr_fused_xy_int8`` replaces the ``int8=True`` branch of the
same Pallas kernel (``corr_pallas.py:232-259``, ``cfg.graph.corr_int8``):
the volume rows are built in f32, quantized to int8 per (edge, pixel tile)
at the tile's max |vol|, and the x stage contracts them with int8 tents.
The scale must exist before any block quantizes, so a max pass
(``corr_int8_vmax``, the same TMA/``wgmma`` build with a max reduction in
place of the lookup) runs first; both are hand kernels in
``csrc/corr_fused_xy.cu``.

K1-raw ``corr_fused_xy(..., raw=True)`` replaces the ``raw=True`` branch of
the same Pallas kernel (``corr_pallas.py:515-516``): the whole per-pixel
32 x 32 block of tap products, every pair of levels, with the
diagonal-level extraction skipped (:func:`raw_corr_index` maps it to the
reference channels).  No path of either package passes ``raw=True``; its
one consumer is the corr encoder's 1024-channel branch
(``models/net.py``).

K2 ``corr_lookup`` replaces ``_lookup_kernel`` (``corr_pallas.py:58``,
driven by ``lookup_pallas``): the same 4-level lookup, y first, on a
prebuilt volume.  It runs in the motion-filter gate on every frame.

Each wrapper launches its kernel for a CUDA tensor and takes the plain
version only for a CPU tensor.  The sources are ``csrc/corr_fused_xy.cu``
and ``csrc/corr_lookup.cu``; :mod:`dbaf_tpu_torch.utils.cuda_build` builds
them with ``nvcc`` on first use.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .corr import DEFAULT_LEVELS, DEFAULT_RADIUS, _round, lookup_fused

NUM_CHANNELS = DEFAULT_LEVELS * (2 * DEFAULT_RADIUS + 1) ** 2  # 196
RAW_CHANNELS = 32 * 32  # K1-raw: the per-pixel 32 x 32 block
K1_CHUNK = 128  # f2 positions per K1 chunk: whole rows, so W2 <= 128
K1_BOX_C = 64  # channels per K1 TMA box (128-byte rows)

# launches of each kernel; a plain integer per wrapper, reset by the caller
LAUNCHES = {"corr_fused_xy": 0, "corr_int8_vmax": 0, "corr_fused_xy_int8": 0,
            "corr_fused_xy_raw": 0, "corr_lookup": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


# ---------------------------------------------------------------------------
# K1: fused build + x-first lookup
# ---------------------------------------------------------------------------

def prepare_corr_fmaps(fmap1: torch.Tensor, fmap2: torch.Tensor):
    """Round-invariant operands of :func:`corr_fused_xy`: both feature maps
    in bf16, divided by 4 and flattened to (E, H*W, C), so
    <f1p[p], f2p[q]> is the reference volume entry (corr.py:63-71)."""
    E, H, W, C = fmap1.shape
    E2, H2, W2, C2 = fmap2.shape
    f1p = (fmap1.to(torch.bfloat16) / 4.0).reshape(E, H * W, C).contiguous()
    f2p = (fmap2.to(torch.bfloat16) / 4.0).reshape(E2, H2 * W2, C2).contiguous()
    return f1p, f2p


def _xy_tent(coord: torch.Tensor, size: int, level: int) -> torch.Tensor:
    """Tent weights of the fused kernel's tables (corr_pallas.py:176-203):
    ``max(0, 1 - |(floor(w/2^l) - off) - coord/2^l|) / 2^l``.
    coord: (E, P).  Returns (E, P, 2r+1, size) f32."""
    inv = 2.0 ** (-level)
    offs = torch.arange(2 * DEFAULT_RADIUS + 1, dtype=torch.float32,
                        device=coord.device) - DEFAULT_RADIUS
    g = torch.floor(torch.arange(size, dtype=torch.float32, device=coord.device) * inv)
    g0 = g[None, :] - offs[:, None]  # (R, size)
    cm = (coord * inv)[..., None, None]
    return torch.clamp(1.0 - torch.abs(g0 - cm), min=0.0) * inv


def corr_fused_xy_plain(f1p: torch.Tensor, f2p: torch.Tensor, coords: torch.Tensor,
                        H2: int, W2: int) -> torch.Tensor:
    """Plain version of K1: what ``corr_fused_xy_prepared(..., raw=False,
    int8=False)`` computes.  The volume is rounded to bf16, then per level
    P2 = bf16(vol @ bf16(kx)) over x, then bf16(bf16(ky) @ P2) over y.

    f1p (E, P, C), f2p (E, H2*W2, C) bf16 from :func:`prepare_corr_fmaps`;
    coords (E, H, W, 2) f32 with H*W == P.  Returns (E, H, W, 196) bf16.
    """
    E, P, C = f1p.shape
    _, H, W, _ = coords.shape
    R = 2 * DEFAULT_RADIUS + 1
    dt = torch.bfloat16
    vol = torch.bmm(f1p.float(), f2p.float().transpose(1, 2)).to(dt).float()
    vol = vol.reshape(E, P, H2, W2)
    flat = coords.reshape(E, P, 2).float()
    outs = []
    for lvl in range(DEFAULT_LEVELS):
        kx = _round(_xy_tent(flat[..., 0], W2, lvl), dt)  # (E,P,R,W2)
        ky = _round(_xy_tent(flat[..., 1], H2, lvl), dt)  # (E,P,R,H2)
        p2 = _round(torch.einsum("ephw,epaw->epha", vol, kx), dt)
        o = torch.einsum("epbh,epha->epab", ky, p2)  # (E,P,x-tap,y-tap)
        outs.append(o.reshape(E, P, R * R))
    out = torch.cat(outs, dim=-1).to(dt)
    return out.reshape(E, H, W, NUM_CHANNELS)


def check_k1_shape(W2: int, C: int) -> None:
    """Raise ``ValueError`` unless K1 takes feature maps W2 wide with C
    channels: W2 <= 128 (a chunk of f2 holds whole rows, so images up to
    1024 px wide) and C <= 128 (two TMA boxes).  The plain version takes
    any shape."""
    _check(W2 <= K1_CHUNK, f"corr_fused_xy: feature width W2={W2} above {K1_CHUNK} "
           f"(image width {8 * W2} px above {8 * K1_CHUNK}): K1 holds whole rows in a chunk")
    _check(C <= 2 * K1_BOX_C, f"corr_fused_xy: C={C} channels above {2 * K1_BOX_C}")


def _k1_operands(name: str, f1p: torch.Tensor, f2p: torch.Tensor, coords: Optional[torch.Tensor],
                 H2: int, W2: int):
    """Checks K1's operands and returns them as its kernels take them:
    channels zero-padded to whole 64-channel TMA boxes (zeros add nothing;
    rows beyond P or P2 are zero-filled by TMA), 16-byte aligned feature
    bases (tensor maps) and 8-byte aligned coordinates (read as float2)."""
    _check(f1p.dtype == torch.bfloat16 and f2p.dtype == torch.bfloat16,
           f"{name}: f1p/f2p must be bf16")
    _check(f1p.ndim == 3 and f2p.ndim == 3, f"{name}: expected f1p (E,P,C), f2p (E,H2*W2,C)")
    E, P, C = f1p.shape
    _check(f2p.shape[0] == E and f2p.shape[2] == C and f2p.shape[1] == H2 * W2,
           f"{name}: f2p shape {tuple(f2p.shape)} does not match (E={E}, H2*W2={H2 * W2}, C={C})")
    _check(f2p.is_cuda and f1p.device == f2p.device, f"{name}: all inputs must be on one CUDA device")
    _check(f1p.is_contiguous() and f2p.is_contiguous(), f"{name}: inputs must be contiguous")
    if coords is not None:
        _check(coords.dtype == torch.float32, f"{name}: coords must be f32")
        _check(coords.is_cuda and coords.device == f1p.device,
               f"{name}: all inputs must be on one CUDA device")
        _check(coords.ndim == 4 and coords.shape[0] == E
               and coords.shape[1] * coords.shape[2] == P and coords.shape[3] == 2,
               f"{name}: coords must be (E, H, W, 2), H*W == P")
        _check(coords.is_contiguous(), f"{name}: inputs must be contiguous")
        if coords.data_ptr() % 8:
            coords = coords.clone()
    check_k1_shape(W2, C)
    cpad = (-C) % K1_BOX_C
    if cpad:
        f1p = F.pad(f1p, (0, cpad))
        f2p = F.pad(f2p, (0, cpad))
    if f1p.data_ptr() % 16:
        f1p = f1p.clone()
    if f2p.data_ptr() % 16:
        f2p = f2p.clone()
    return f1p, f2p, coords


def corr_fused_xy(f1p: torch.Tensor, f2p: torch.Tensor, coords: torch.Tensor,
                  H2: int, W2: int, raw: bool = False) -> torch.Tensor:
    """Fused correlation build + 4-level lookup, channels-last bf16.

    Same contract as :func:`corr_fused_xy_plain`, or with ``raw=True`` as
    :func:`corr_fused_xy_raw_plain`.  A CUDA input launches kernel K1 (or
    K1-raw), within the limits of :func:`check_k1_shape`, and raises beyond
    them; a CPU input takes the plain version.
    """
    if not f1p.is_cuda:
        plain = corr_fused_xy_raw_plain if raw else corr_fused_xy_plain
        return plain(f1p, f2p, coords, H2, W2)
    name = "corr_fused_xy_raw" if raw else "corr_fused_xy"
    f1p, f2p, coords = _k1_operands(name, f1p, f2p, coords, H2, W2)
    E, P, Cpad = f1p.shape
    from ..utils.cuda_build import load_kernel_library

    lib = load_kernel_library("corr_fused_xy")
    out = torch.empty((E, coords.shape[1], coords.shape[2], RAW_CHANNELS if raw else NUM_CHANNELS),
                      dtype=torch.bfloat16, device=f1p.device)
    launch = lib.corr_fused_xy_raw_launch if raw else lib.corr_fused_xy_launch
    rc = launch(_ptr(f1p), _ptr(f2p), _ptr(coords), _ptr(out), E, P, H2, W2, Cpad, _stream())
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# K1-raw: the raw 32 x 32 block layout
# ---------------------------------------------------------------------------

def raw_corr_index(radius: int = DEFAULT_RADIUS, num_levels: int = DEFAULT_LEVELS) -> np.ndarray:
    """The reference channel of each raw block position
    (``corr_pallas.py:393-420``): position (l*R + dy) * 32 + (l*R + dx), a
    y tap and an x tap of the same level l, holds channel l*R*R + dx*R + dy;
    every other position (the products of two levels, and rows and columns
    28-31) gets -1.  Returns (1024,) int32."""
    R = 2 * radius + 1
    idx = np.full(RAW_CHANNELS, -1, np.int32)
    for lvl in range(num_levels):
        for dy in range(R):
            for dx in range(R):
                idx[(lvl * R + dy) * 32 + (lvl * R + dx)] = lvl * R * R + dx * R + dy
    return idx


def corr_fused_xy_raw_plain(f1p: torch.Tensor, f2p: torch.Tensor, coords: torch.Tensor,
                            H2: int, W2: int) -> torch.Tensor:
    """Plain version of K1-raw: what ``corr_fused_xy_prepared(...,
    raw=True)`` computes.  Row i = l*7 + dy of a pixel's block is a y tap
    at level l, column j = l'*7 + dx an x tap at level l', over every pair
    of levels: P2[h, j] = bf16(sum_w vol[h, w] * bf16(kx_j(w))) and
    out[i, j] = bf16(sum_h bf16(ky_i(h)) * P2[h, j]); rows and columns
    28-31 are 0.  Inputs as :func:`corr_fused_xy_plain`; returns
    (E, H, W, 1024) bf16."""
    E, P, C = f1p.shape
    _, H, W, _ = coords.shape
    R = 2 * DEFAULT_RADIUS + 1
    LR = DEFAULT_LEVELS * R
    dt = torch.bfloat16
    vol = torch.bmm(f1p.float(), f2p.float().transpose(1, 2)).to(dt).float()
    vol = vol.reshape(E, P, H2, W2)
    flat = coords.reshape(E, P, 2).float()
    kx = torch.cat([_round(_xy_tent(flat[..., 0], W2, lvl), dt)
                    for lvl in range(DEFAULT_LEVELS)], dim=2)  # (E, P, 28, W2)
    ky = torch.cat([_round(_xy_tent(flat[..., 1], H2, lvl), dt)
                    for lvl in range(DEFAULT_LEVELS)], dim=2)  # (E, P, 28, H2)
    p2 = _round(torch.einsum("ephw,epjw->ephj", vol, kx), dt)
    out = torch.zeros((E, P, 32, 32), dtype=torch.float32, device=f1p.device)
    out[:, :, :LR, :LR] = torch.einsum("epih,ephj->epij", ky, p2)
    return out.to(dt).reshape(E, H, W, RAW_CHANNELS)


# ---------------------------------------------------------------------------
# K1-int8: the int8 branch of the fused kernel
# ---------------------------------------------------------------------------

INT8_LEVELS = 127.0  # int8 quantization steps per unit of the scale


def int8_tile(h8: int, w8: int, group: int) -> Optional[int]:
    """Source pixels that share one int8 scale, as the JAX package's
    ``corr_blk_layout`` (``dbaf_tpu/slam/graph.py:85-97``) tiles them:
    ``max(128, 16 * group)``, or 128 (group 8) when the grid holds no whole
    tile of that size.  None when the grid does not hold whole tiles
    either: the JAX package then runs the bf16 lookup, and so does the
    port."""
    pix = h8 * w8
    tile = max(128, 16 * group)
    if pix % tile:
        group, tile = 8, 128
    return tile if pix % tile == 0 and tile % group == 0 else None


def corr_int8_vmax_plain(f1p: torch.Tensor, f2p: torch.Tensor, tile: int,
                         vol: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the max pass: max(max |vol|, 1e-20) over each
    edge's tiles of ``tile`` source pixels x every target position, the
    volume in f32 (``vol``, the (E, P, P2) product, where the caller has
    it).  Returns (E, P // tile) f32."""
    E, P, _ = f1p.shape
    if vol is None:
        vol = torch.bmm(f1p.float(), f2p.float().transpose(1, 2))
    return torch.clamp(vol.abs().reshape(E, P // tile, -1).amax(-1), min=1e-20)


def corr_fused_xy_int8_plain(f1p: torch.Tensor, f2p: torch.Tensor, coords: torch.Tensor,
                             H2: int, W2: int, tile: int) -> torch.Tensor:
    """Plain version of K1-int8: what ``corr_fused_xy_prepared(...,
    int8=True, tile=tile)`` computes (corr_pallas.py:232-259).  The volume
    stays f32; per (edge, tile) q = round(vol * 127 / vmax) and, per level,
    qx = round(127 * kx), P2 = bf16(sum_w q * qx * vmax / 127^2) (the sums
    are integers below 2^24, so f32 holds them exactly), then the bf16 y
    stage of :func:`corr_fused_xy_plain`.  Returns (E, H, W, 196) bf16."""
    E, P, C = f1p.shape
    _, H, W, _ = coords.shape
    R = 2 * DEFAULT_RADIUS + 1
    dt = torch.bfloat16
    vol = torch.bmm(f1p.float(), f2p.float().transpose(1, 2))
    vmax = corr_int8_vmax_plain(f1p, f2p, tile, vol)
    vmax = vmax[:, :, None].expand(E, P // tile, tile).reshape(E, P)
    q = torch.round(vol * (INT8_LEVELS / vmax)[..., None]).reshape(E, P, H2, W2)
    scale = (vmax * (1.0 / (INT8_LEVELS * INT8_LEVELS)))[..., None, None]
    flat = coords.reshape(E, P, 2).float()
    outs = []
    for lvl in range(DEFAULT_LEVELS):
        qx = torch.round(_xy_tent(flat[..., 0], W2, lvl) * INT8_LEVELS)
        ky = _round(_xy_tent(flat[..., 1], H2, lvl), dt)
        p2 = _round(torch.einsum("ephw,epaw->epha", q, qx) * scale, dt)
        o = torch.einsum("epbh,epha->epab", ky, p2)
        outs.append(o.reshape(E, P, R * R))
    return torch.cat(outs, dim=-1).to(dt).reshape(E, H, W, NUM_CHANNELS)


# K1-int8 against its plain version: the share of outputs that may differ by
# more than one bf16 ulp (see int8_agreement)
INT8_OFF_SHARE = 1e-3


class Int8Agreement(NamedTuple):
    max_abs_err: float
    max_bound: float  # the largest per-output bound
    off_share: float  # share of outputs more than one bf16 ulp of |ref| apart
    ok: bool          # every output within its bound, off_share <= INT8_OFF_SHARE


def int8_agreement(out: torch.Tensor, ref: torch.Tensor, vmax: torch.Tensor, tile: int,
                   keep: Optional[torch.Tensor] = None) -> Int8Agreement:
    """How an int8 lookup ``out`` agrees with ``ref`` (both (E, H, W, 196),
    ``ref`` from :func:`corr_fused_xy_int8_plain`) at the tile scales
    ``vmax`` (E, P // tile); ``keep`` (H bools) selects the rows compared.

    Both round at the same points and differ in the order of the volume's
    f32 sums (and so, by an f32 ulp, in ``vmax``).  That flips the rounding
    of a quantized entry only within a hair of a half step; an output none
    of whose entries flipped differs by the bf16 rounding of its y sum, at
    most one bf16 ulp of ``|ref|``.  So at most :data:`INT8_OFF_SHARE` of
    the outputs may differ by more, each within its bound: one int8
    quantum of its tile's scale per tap, ``vmax * 1.07 / 127`` (a tap's x
    tents sum to at most 1 plus half a step per support column, its y
    tents to 1), plus one bf16 ulp of P2 (``2^-7 vmax``) and of the output
    (``2^-7 |ref|``).  A lookup that skips the quantization stays within
    the per-output bound (it differs by up to about 1.5 quanta) but not
    within one ulp at most outputs."""
    E, H, W, _ = ref.shape
    ref32 = ref.float()
    err = (out.float() - ref32).abs()
    v = vmax[:, :, None].expand(E, vmax.shape[1], tile).reshape(E, H, W, 1)
    bnd = v * (1.07 / INT8_LEVELS + 2.0 ** -7) + 2.0 ** -7 * ref32.abs()
    _, e = torch.frexp(ref32)
    ulp = torch.where(ref32 == 0, 0.0, torch.ldexp(torch.ones_like(ref32), e - 8))
    if keep is not None:
        err, bnd, ulp = err[:, keep], bnd[:, keep], ulp[:, keep]
    share = float((err > ulp).float().mean())
    ok = bool((err <= bnd).all()) and share <= INT8_OFF_SHARE
    return Int8Agreement(float(err.max()), float(bnd.max()), share, ok)


def _check_tile(name: str, P: int, tile: int) -> None:
    _check(tile % 64 == 0 and P % tile == 0,
           f"{name}: tile {tile} must be a multiple of 64 that divides P={P}")


def corr_int8_vmax(f1p: torch.Tensor, f2p: torch.Tensor, H2: int, W2: int,
                   tile: int) -> torch.Tensor:
    """The max pass of K1-int8: (E, P // tile) f32, the contract of
    :func:`corr_int8_vmax_plain`.  A CUDA input launches the kernel (K1's
    limits), a CPU input takes the plain version."""
    if not f1p.is_cuda:
        return corr_int8_vmax_plain(f1p, f2p, tile)
    f1p, f2p, _ = _k1_operands("corr_int8_vmax", f1p, f2p, None, H2, W2)
    E, P, Cpad = f1p.shape
    _check_tile("corr_int8_vmax", P, tile)
    from ..utils.cuda_build import load_kernel_library

    lib = load_kernel_library("corr_fused_xy")
    vmax = torch.zeros((E, P // tile), dtype=torch.float32, device=f1p.device)
    rc = lib.corr_int8_vmax_launch(_ptr(f1p), _ptr(f2p), _ptr(vmax), E, P, H2, W2, Cpad, tile,
                                   _stream())
    _raise_on(rc, "corr_int8_vmax")
    LAUNCHES["corr_int8_vmax"] += 1
    return torch.clamp(vmax, min=1e-20)


def corr_fused_xy_int8(f1p: torch.Tensor, f2p: torch.Tensor, coords: torch.Tensor,
                       H2: int, W2: int, tile: int) -> torch.Tensor:
    """Fused correlation build + int8 x stage + 4-level lookup, the
    contract of :func:`corr_fused_xy_int8_plain`.  A CUDA input launches
    the max pass, then kernel K1-int8 (K1's limits; ``tile`` a multiple of
    64 that divides P), and raises where either does; a CPU input takes the
    plain version."""
    if not f1p.is_cuda:
        return corr_fused_xy_int8_plain(f1p, f2p, coords, H2, W2, tile)
    vmax = corr_int8_vmax(f1p, f2p, H2, W2, tile)
    f1p, f2p, coords = _k1_operands("corr_fused_xy_int8", f1p, f2p, coords, H2, W2)
    E, P, Cpad = f1p.shape
    from ..utils.cuda_build import load_kernel_library

    lib = load_kernel_library("corr_fused_xy")
    out = torch.empty((E, coords.shape[1], coords.shape[2], NUM_CHANNELS),
                      dtype=torch.bfloat16, device=f1p.device)
    rc = lib.corr_fused_xy_int8_launch(_ptr(f1p), _ptr(f2p), _ptr(coords), _ptr(vmax), _ptr(out),
                                       E, P, H2, W2, Cpad, tile, _stream())
    _raise_on(rc, "corr_fused_xy_int8")
    LAUNCHES["corr_fused_xy_int8"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: lookup on a prebuilt volume
# ---------------------------------------------------------------------------

def corr_lookup_plain(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Plain version of K2 (``lookup_fused``): (E, 196, H, W) f32."""
    return lookup_fused(volume, coords)


def corr_lookup(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """4-level windowed lookup on a prebuilt (E, H*W, H2, W2) volume.

    volume bf16 or f32; coords (E, H, W, 2) f32 at level-0 scale.  Returns
    (E, 196, H, W) f32 in the reference channel order.  A CUDA volume
    launches kernel K2, which raises where two volume rows do not fit one
    block's shared memory (H2*W2 above 57k in bf16 or 28k in f32 on the
    H100); a CPU volume takes the plain version.
    """
    if not volume.is_cuda:
        return corr_lookup_plain(volume, coords)
    _check(volume.dtype in (torch.bfloat16, torch.float32),
           "corr_lookup: volume must be bf16 or f32")
    _check(coords.dtype == torch.float32, "corr_lookup: coords must be f32")
    _check(coords.is_cuda and coords.device == volume.device,
           "corr_lookup: coords must be on the volume's device")
    _check(volume.ndim == 4 and coords.ndim == 4 and coords.shape[3] == 2,
           "corr_lookup: expected volume (E,P,H2,W2) and coords (E,H,W,2)")
    E, P, H2, W2 = volume.shape
    _, H, W, _ = coords.shape
    _check(coords.shape[0] == E and H * W == P,
           f"corr_lookup: coords {tuple(coords.shape)} do not match volume {tuple(volume.shape)}")
    _check(volume.is_contiguous() and coords.is_contiguous(),
           "corr_lookup: inputs must be contiguous")
    if coords.data_ptr() % 8:  # read as float2
        coords = coords.clone()
    from ..utils.cuda_build import load_kernel_library

    lib = load_kernel_library("corr_lookup")
    out = torch.empty((E, NUM_CHANNELS, H, W), dtype=torch.float32, device=volume.device)
    is_bf16 = 1 if volume.dtype == torch.bfloat16 else 0
    rc = lib.corr_lookup_launch(
        _ptr(volume), _ptr(coords), _ptr(out), E, P, H2, W2, is_bf16, _stream(),
    )
    _raise_on(rc, "corr_lookup")
    LAUNCHES["corr_lookup"] += 1
    return out
