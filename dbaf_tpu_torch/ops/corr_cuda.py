"""Hand-written CUDA kernels for the correlation lookups, with their wrappers,
launch counters and plain PyTorch versions.

K1 ``corr_fused_xy`` replaces the Pallas kernel ``_fused_xy_kernel``
(``dbaf_tpu/ops/corr_pallas.py:206``, driven by ``corr_fused_xy_prepared``):
the correlation rows are built in shared memory (``wgmma`` on TMA-fed
tiles) and contracted with the 4-level tent weights, x first, without ever
storing the volume.  It runs in every update round for every active edge.

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

import torch
import torch.nn.functional as F

from .corr import DEFAULT_LEVELS, DEFAULT_RADIUS, _round, lookup_fused

NUM_CHANNELS = DEFAULT_LEVELS * (2 * DEFAULT_RADIUS + 1) ** 2  # 196
K1_CHUNK = 128  # f2 positions per K1 chunk: whole rows, so W2 <= 128
K1_BOX_C = 64  # channels per K1 TMA box (128-byte rows)

# launches of each kernel; a plain integer per wrapper, reset by the caller
LAUNCHES = {"corr_fused_xy": 0, "corr_lookup": 0}


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


def corr_fused_xy(f1p: torch.Tensor, f2p: torch.Tensor, coords: torch.Tensor,
                  H2: int, W2: int) -> torch.Tensor:
    """Fused correlation build + 4-level lookup, channels-last bf16.

    Same contract as :func:`corr_fused_xy_plain`.  A CUDA input launches
    kernel K1, within the limits of :func:`check_k1_shape`, and raises
    beyond them; a CPU input takes the plain version.
    """
    if not f1p.is_cuda:
        return corr_fused_xy_plain(f1p, f2p, coords, H2, W2)
    _check(f1p.dtype == torch.bfloat16 and f2p.dtype == torch.bfloat16,
           "corr_fused_xy: f1p/f2p must be bf16")
    _check(coords.dtype == torch.float32, "corr_fused_xy: coords must be f32")
    _check(f2p.is_cuda and coords.is_cuda and f1p.device == f2p.device == coords.device,
           "corr_fused_xy: all inputs must be on one CUDA device")
    _check(f1p.ndim == 3 and f2p.ndim == 3 and coords.ndim == 4,
           "corr_fused_xy: expected f1p (E,P,C), f2p (E,H2*W2,C), coords (E,H,W,2)")
    E, P, C = f1p.shape
    _check(f2p.shape[0] == E and f2p.shape[2] == C and f2p.shape[1] == H2 * W2,
           f"corr_fused_xy: f2p shape {tuple(f2p.shape)} does not match "
           f"(E={E}, H2*W2={H2 * W2}, C={C})")
    _check(coords.shape[0] == E and coords.shape[1] * coords.shape[2] == P
           and coords.shape[3] == 2, "corr_fused_xy: coords must be (E, H, W, 2), H*W == P")
    _check(f1p.is_contiguous() and f2p.is_contiguous() and coords.is_contiguous(),
           "corr_fused_xy: inputs must be contiguous")
    check_k1_shape(W2, C)
    # TMA boxes are 64 channels (128-byte rows): pad channels with zeros,
    # which add nothing.  Rows beyond P or P2 are zero-filled by TMA.
    cpad = (-C) % K1_BOX_C
    if cpad:
        f1p = F.pad(f1p, (0, cpad))
        f2p = F.pad(f2p, (0, cpad))
    # tensor maps need 16-byte aligned bases; coords are read as float2
    if f1p.data_ptr() % 16:
        f1p = f1p.clone()
    if f2p.data_ptr() % 16:
        f2p = f2p.clone()
    if coords.data_ptr() % 8:
        coords = coords.clone()
    from ..utils.cuda_build import load_kernel_library

    lib = load_kernel_library("corr_fused_xy")
    out = torch.empty((E, coords.shape[1], coords.shape[2], NUM_CHANNELS),
                      dtype=torch.bfloat16, device=f1p.device)
    rc = lib.corr_fused_xy_launch(
        _ptr(f1p), _ptr(f2p), _ptr(coords), _ptr(out), E, P, H2, W2, f1p.shape[2], _stream(),
    )
    _raise_on(rc, "corr_fused_xy")
    LAUNCHES["corr_fused_xy"] += 1
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
