"""Device resolution for the port's entry points.

Entry points default to the card.  Without one they raise instead of
falling back to the CPU; the CPU runs only where a caller asks for it
(``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Union

import numpy as np
import torch

from .profiling import TRACER


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dbaf_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch path on the CPU"
            )
        configure_cuda_numerics()
    return dev


def configure_cuda_numerics() -> None:
    """Full-f32 matrix products and convolutions on the card.

    The dense-BA Gram products and Schur complement are solver-grade (the
    JAX package runs them at ``Precision.HIGHEST``), and TF32 keeps only
    about three decimal digits, so both switches are off: matmuls
    (``torch.backends.cuda.matmul.allow_tf32``) and cuDNN convolutions
    (``torch.backends.cudnn.allow_tf32``, which PyTorch turns on by
    default).  The network's bf16 convolutions are unaffected; the f32
    network used for parity checks stays exact.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# device -> host reads made through :func:`to_host` (the coupled path's
# cull decisions, LM stopping flags, host packs and state pulls); the chip
# smoke test reports them per keyframe
HOST_READS = {"count": 0}

# The process group of the live keyframe-sharded video
# (``slam/video.py::DepthVideo`` sets it, None without one).  While it is
# set, every counted read (:func:`to_host`, :class:`PendingRead`) returns
# the group's first rank's value: the ranks run the same frames and read
# the same replicated tensors at the same points, so the host decisions
# taken from the reads (admission, edge selection, culls, rollups) are the
# first rank's on every rank, and the ranks' feature gathers stay in step
# even where their replicated values differ in the last bits.  A
# non-blocking :class:`FlagPoll` answers by timing on each rank; the rounds
# it gates issue no gather and run masked until it answers, so it needs
# no such read.
HOST_SYNC = {"group": None}


def _first_rank_value(x: torch.Tensor) -> torch.Tensor:
    group = HOST_SYNC["group"]
    if group is None:
        return x
    from ..parallel.collectives import broadcast_first

    return broadcast_first(x, group)


def to_host(x: torch.Tensor):
    """One counted device -> host read: a Python scalar for a 0-d tensor,
    else a numpy array (the first rank's, see ``HOST_SYNC``); a ``wait``
    span."""
    HOST_READS["count"] += 1
    with TRACER("wait"):
        x = _first_rank_value(x)
        if x.dim() == 0:
            return x.item()
        return x.detach().cpu().numpy()


# deliberate waits for the card in progress (host_wait): a test guard that
# flags host reads on the CPU lets these through
WAITING = {"depth": 0}


@contextlib.contextmanager
def host_wait():
    """Marks a deliberate wait for the card: inside it CUDA's sync debug
    mode (``torch.cuda.set_sync_debug_mode``) is off, so a caller that
    guards a steady-state stretch with ``"error"`` lets through the waits
    that belong there (the motion gate's per-frame read, the lagged drain of
    the asynchronous coupled pipeline).  Its body is a ``wait`` span."""
    mode = torch.cuda.get_sync_debug_mode() if torch.cuda.is_available() else None
    if mode is not None:
        torch.cuda.set_sync_debug_mode(0)
    WAITING["depth"] += 1
    try:
        with TRACER("wait"):
            yield
    finally:
        WAITING["depth"] -= 1
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> ``device`` with no stream synchronisation (see
    :func:`_h2d`)."""
    return _h2d(torch.from_numpy(np.ascontiguousarray(a)), device)


def _h2d(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy from pageable memory synchronises, so on the card the host
    tensor is staged in pinned memory and copied with ``non_blocking=True``;
    PyTorch's caching host allocator records an event on the staging block
    at the copy and reuses the block only once that event has completed."""
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class FlagPoll:
    """Reads of a 0-d device flag (an LM loop's ``done``, which once True
    stays True; a keyframe's cull decision).

    Non-blocking (the default): :meth:`post` copies the flag into pinned
    host memory behind a CUDA event; :meth:`value` answers from the newest
    post whose event has completed and never waits (None while none has).
    On the CPU the flag is on the host already and :meth:`post` reads it at
    once.  ``blocking=True`` (the synchronous flow) makes :meth:`post` one
    counted :func:`to_host` read, so :meth:`value` always answers.
    ``posted`` counts posts over the object's life (the LM loop posts once
    per launched iteration, and asks :meth:`value_within` before each)."""

    def __init__(self, blocking: bool = False):
        self.blocking = blocking
        self._posts = []
        self._value = None
        self.posted = 0

    def reset(self) -> None:
        self._posts = []
        self._value = None

    def post(self, flag: torch.Tensor) -> None:
        self.posted += 1
        if self.blocking:
            self._value = bool(to_host(flag))
            return
        if not flag.is_cuda:
            with host_wait():
                self._value = bool(flag)
            return
        host = torch.empty((), dtype=flag.dtype, pin_memory=True)
        host.copy_(flag, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._posts.append((host, ev))

    def value(self) -> Optional[bool]:
        for k in range(len(self._posts) - 1, -1, -1):
            host, ev = self._posts[k]
            if ev.query():
                self._value = bool(host)
                del self._posts[:k + 1]
                break
        return self._value

    def value_within(self, lag: int) -> Optional[bool]:
        """:meth:`value`, once at most ``lag`` posts are still unanswered:
        where more are, first waits (a :func:`host_wait`) for the post
        ``lag`` before the newest.  A loop that posts once per launch and
        asks this before each launch runs at most ``lag`` launches past its
        newest answer."""
        known = self.value()
        if not known and len(self._posts) > lag:
            with host_wait():
                self._posts[-1 - lag][1].synchronize()
            known = self.value()
        return known


class PendingRead:
    """A device tensor on its way to the host: a ``non_blocking`` copy into
    pinned memory behind a CUDA event (on the CPU, the tensor itself), with
    the caller's ``meta`` riding along (the first rank's tensor, see
    ``HOST_SYNC``)."""

    def __init__(self, x: torch.Tensor, *meta):
        self.meta = meta
        x = _first_rank_value(x)
        if x.is_cuda:
            self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self.host.copy_(x, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = x, None

    def read(self) -> np.ndarray:
        """Waits for this copy alone (never for later work) and counts one
        host read; a ``wait`` span."""
        HOST_READS["count"] += 1
        with TRACER("wait"):
            if self.event is not None:
                with host_wait():
                    self.event.synchronize()
            return self.landed()

    def landed(self) -> np.ndarray:
        """The copy, which must have landed: a :meth:`read` waited for it
        or for a later copy on the same stream.  No wait, no count."""
        return self.host.numpy().copy()


def device_const(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant vector on ``device``, uploaded once per (values,
    dtype, device) with no stream synchronisation and shared by every later
    caller: never write into it."""
    return _device_const(tuple(values), dtype, torch.device(device))


@functools.lru_cache(maxsize=None)
def _device_const(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return _h2d(torch.tensor(values, dtype=dtype), device)


def clip(x, lo: int, hi: int):
    """``min(max(x, lo), hi)`` for an int or a device tensor (no host read)."""
    if isinstance(x, torch.Tensor):
        return torch.clamp(x, lo, hi)
    return min(max(x, lo), hi)


def rows_at(buf: torch.Tensor, idx) -> torch.Tensor:
    """``buf[idx]`` for an int or a 0-d device index (indexing with a 0-d
    tensor reads it back to the host)."""
    if isinstance(idx, torch.Tensor):
        return buf.index_select(0, idx.reshape(1))[0]
    return buf[idx]


def set_row(buf: torch.Tensor, idx, row: torch.Tensor) -> None:
    """``buf[idx] = row`` in place, for an int or a 0-d device index."""
    if isinstance(idx, torch.Tensor):
        buf.index_copy_(0, idx.reshape(1), row[None].to(buf.dtype))
    else:
        buf[idx] = row
