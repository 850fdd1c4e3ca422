"""Tracing and profiling (port of ``dbaf_tpu/utils/profiling.py``).

* ``StageTimer``: the program's tracer.  Each span (``with timer("stage"):``)
  records its stage, start and end (one ``time.perf_counter()`` read each),
  its parent span, the frame it ran under and, where given, the frame whose
  work it finishes (``cause``), into a preallocated ring in memory; the
  one-line report gives each stage's self time (its spans less the part their
  child spans cover; in place of the reference's log-timestamp reading,
  dbaf_frontend.py:164+).  ``TRACER`` is the process-wide instance the
  program's span sites use; it is off until :func:`set_tracing` turns it on,
  and off, a span site costs an attribute read and a branch.
* ``device_trace``: a context manager around ``torch.profiler``, with CUDA
  activities when a card is present; it writes a Chrome trace into
  ``logdir``.  With tracing on, every span is also a ``record_function``
  range there, beside the kernels it launched.
* ``get_logger``: the ``dba_fusion`` file logger of the reference's logging
  surface (depth_video.py:117-124).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
import warnings
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

RING = 65536  # spans kept; a 51 s window of 15-40 spans a frame needs at most about 4,100
WAIT = "wait"  # the stage of a deliberate wait for the card
SYNC_WARNING = "called a synchronizing CUDA operation"  # CUDA's sync debug mode "warn"
SYNC_SITES = 8  # call sites of unplanned synchronisations kept


def get_logger(path: Optional[str] = None) -> logging.Logger:
    logger = logging.getLogger("dba_fusion")
    if not logger.handlers:
        logger.setLevel(logging.DEBUG)
        handler = logging.FileHandler(path) if path else logging.NullHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
        logger.addHandler(handler)
    return logger


class _Off:
    """The span a site enters while its timer is off: nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class StageTimer:
    """Per-stage timer and span recorder.

    >>> timer = StageTimer()
    >>> with timer("update"):
    ...     ...
    >>> timer.report()

    A span opened with ``root=True`` starts a new frame (``frame``, the
    sequence number of the root spans) and counts the unplanned
    synchronisations inside it (:func:`set_tracing`).  A span of the stage
    of the span it opens in records nothing of its own (a wait inside a
    wait is counted once).  The ring holds the newest ``RING`` spans; their
    sequence numbers (``seq``) keep counting, and :meth:`spans` returns the
    spans since a sequence number that are still there.
    """

    def __init__(self, on: bool = True):
        self.on = on
        self.totals: Dict[str, float] = defaultdict(float)  # self seconds
        self.counts: Dict[str, int] = defaultdict(int)
        self.ring = dict(stage=np.zeros(RING, np.int32), start=np.zeros(RING),
                         end=np.zeros(RING), child=np.zeros(RING),
                         parent=np.zeros(RING, np.int64), frame=np.zeros(RING, np.int64),
                         cause=np.zeros(RING, np.int64))
        self.stages = []  # stage names by id
        self._ids: Dict[str, int] = {}
        self.seq = 0       # spans recorded
        self.frame = -1    # the newest root span's frame id
        self.syncs = 0     # unplanned synchronisations counted
        self.sync_sites: Dict[str, int] = {}
        # the factor graph's LM passes and the iterations they launched
        # (masked ones included), and of those the CUDA graph replays and
        # the ones relinearized by the hand kernel
        # (``fusion/device_graph.lm_optimize``): counted whether on or off
        self.lm_passes = self.lm_launched = self.lm_replayed = 0
        self.lm_kernel_linearized = 0
        # counted only while on (one branch at its site when off): the
        # active edges the update rounds' short-baseline mask down-weighted,
        # a 0-d device sum that no site reads (see mark)
        self.masked_edges: Optional[torch.Tensor] = None
        self._stack = []   # open spans: (seq, stage, record_function or None, kind)
        self._next = (None, -1, False)
        self._roots = 0    # open root spans
        self._waits = 0    # open wait spans
        self._profiled = False  # torch.profiler recording, read at each root span
        self._warnings = None   # (catch_warnings, showwarning) while syncs are watched
        self._sync_mode = 0     # CUDA's sync debug mode before they were

    def __call__(self, stage: str, cause: int = -1, root: bool = False):
        if not self.on:
            return _OFF
        self._next = (stage, cause, root)
        return self

    def __enter__(self):
        stage, cause, root = self._next
        stack = self._stack
        if stack and stack[-1][1] == stage:
            stack.append((stack[-1][0], stage, None, 0))
            return self
        if root:
            self.frame += 1
            self._roots += 1
            self._profiled = torch._C._autograd._profiler_enabled()
        if stage == WAIT:
            self._waits += 1
        sid = self._ids.get(stage)
        if sid is None:
            sid = self._ids[stage] = len(self.stages)
            self.stages.append(stage)
        seq = self.seq
        self.seq += 1
        i = seq % RING
        r = self.ring
        r["stage"][i] = sid
        r["child"][i] = 0.0
        r["parent"][i] = stack[-1][0] if stack else -1
        r["frame"][i] = self.frame
        r["cause"][i] = cause
        rf = None
        if self._profiled:
            rf = torch.autograd.profiler.record_function(stage)
            rf.__enter__()
        stack.append((seq, stage, rf, 2 if root else 1))
        r["start"][i] = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t = time.perf_counter()
        if not self._stack:  # opened before a reset
            return False
        seq, stage, rf, kind = self._stack.pop()
        if not kind:
            return False
        r = self.ring
        i = seq % RING
        r["end"][i] = t
        d = t - r["start"][i]
        self.totals[stage] += d - r["child"][i]
        self.counts[stage] += 1
        if self._stack:
            r["child"][self._stack[-1][0] % RING] += d
        if rf is not None:
            rf.__exit__(None, None, None)
        if stage == WAIT:
            self._waits -= 1
        if kind == 2:
            self._roots -= 1
        return False

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        out = []
        for stage, total in rows:
            n = self.counts[stage]
            out.append(f"{stage}: {1000*total:.1f} ms total, "
                       f"{1000*total/max(n,1):.1f} ms/call x{n}")
        return "\n".join(out)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
        self._stack.clear()
        self._roots = self._waits = 0
        self.seq = 0
        self.frame = -1
        self.syncs = 0
        self.sync_sites.clear()
        self.lm_passes = self.lm_launched = self.lm_replayed = 0
        self.lm_kernel_linearized = 0
        self.masked_edges = None

    def add_masked(self, cut: torch.Tensor) -> None:
        """Add the count of true flags in ``cut`` to ``masked_edges`` on
        their device, with no host read."""
        n = cut.sum()
        if self.masked_edges is None or self.masked_edges.device != n.device:
            self.masked_edges = torch.zeros((), dtype=n.dtype, device=n.device)
        self.masked_edges.add_(n)

    # -- reading the ring -------------------------------------------------------
    def mark(self) -> dict:
        """Where the ring and the counters stand (for :meth:`spans`);
        ``masked_edges`` is a copy of the device sum (or None), read by
        whoever compares two marks."""
        masked = None if self.masked_edges is None else self.masked_edges.clone()
        return dict(seq=self.seq, frame=self.frame, syncs=self.syncs,
                    lm_passes=self.lm_passes, lm_launched=self.lm_launched,
                    lm_replayed=self.lm_replayed,
                    lm_kernel_linearized=self.lm_kernel_linearized, masked_edges=masked)

    def spans(self, since: int = 0) -> dict:
        """The closed spans from sequence number ``since`` on that the ring
        still holds, as arrays: ``seq``, ``stage`` (names), ``start``, ``end``,
        ``self`` (seconds less the children), ``parent`` (its sequence number,
        -1 at the root), ``frame`` and ``cause`` (-1 where none)."""
        seq = np.arange(max(since, self.seq - RING), self.seq)
        i = seq % RING
        r = self.ring
        open_ = {s for s, _, _, kind in self._stack if kind}
        keep = np.array([s not in open_ for s in seq], bool) if open_ else slice(None)
        out = dict(seq=seq, stage=np.asarray(self.stages + [""], object)[r["stage"][i]],
                   **{k: r[k][i] for k in ("start", "end", "parent", "frame", "cause")})
        out["self"] = r["end"][i] - r["start"][i] - r["child"][i]
        return {k: v[keep] for k, v in out.items()}

    # -- unplanned synchronisations ---------------------------------------------
    def _show(self, message, category, filename, lineno, file=None, line=None):
        """``warnings.showwarning`` while tracing: CUDA's sync warnings are
        counted inside a root span and outside a wait, and never shown."""
        if not str(message).startswith(SYNC_WARNING):
            return self._warnings[1](message, category, filename, lineno, file, line)
        if self._roots and not self._waits:
            self.syncs += 1
            site = f"{filename}:{lineno}"
            if site in self.sync_sites or len(self.sync_sites) < SYNC_SITES:
                self.sync_sites[site] = self.sync_sites.get(site, 0) + 1
        return None

    def _watch_syncs(self, on: bool):
        if on and self._warnings is None:
            ctx = warnings.catch_warnings()
            ctx.__enter__()
            warnings.filterwarnings("always", message=SYNC_WARNING)
            self._warnings = (ctx, warnings.showwarning)
            warnings.showwarning = self._show
            if torch.cuda.is_available():
                self._sync_mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
        elif not on and self._warnings is not None:
            if torch.cuda.is_available():
                torch.cuda.set_sync_debug_mode(self._sync_mode)
            self._warnings[0].__exit__(None, None, None)
            self._warnings = None


# the program's tracer: every span site of the port enters it
TRACER = StageTimer(on=False)


def set_tracing(on: bool = True) -> StageTimer:
    """Turn the program's tracer on or off.  On, every span site records
    into ``TRACER``'s ring, each span is a ``record_function`` range while
    ``torch.profiler`` records, and CUDA's sync debug mode is ``"warn"``:
    each synchronising call inside a ``DBAFusion.track`` (a root span),
    outside a deliberate wait (``utils/device.host_wait``, ``to_host``,
    ``PendingRead.read``), counts one in ``TRACER.syncs``, silently."""
    TRACER._watch_syncs(on)
    TRACER.on = on
    return TRACER


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` trace of the block, CPU activities and, with a
    card, CUDA ones; written to ``logdir/trace.json`` (open it in Perfetto
    or ``chrome://tracing``).  With :func:`set_tracing` on, the program's
    stages are ranges on the trace's host timeline."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
