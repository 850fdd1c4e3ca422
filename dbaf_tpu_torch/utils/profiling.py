"""Tracing and profiling (port of ``dbaf_tpu/utils/profiling.py``).

* ``StageTimer``: per-stage wall-clock accounting with a one-line report
  (in place of the reference's log-timestamp reading, dbaf_frontend.py:164+).
* ``device_trace``: a context manager around ``torch.profiler``, with CUDA
  activities when a card is present; it writes a Chrome trace into
  ``logdir``.
* ``get_logger``: the ``dba_fusion`` file logger of the reference's logging
  surface (depth_video.py:117-124).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Optional


def get_logger(path: Optional[str] = None) -> logging.Logger:
    logger = logging.getLogger("dba_fusion")
    if not logger.handlers:
        logger.setLevel(logging.DEBUG)
        handler = logging.FileHandler(path) if path else logging.NullHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
        logger.addHandler(handler)
    return logger


class StageTimer:
    """Accumulating per-stage timer.

    >>> timer = StageTimer()
    >>> with timer("update"):
    ...     ...
    >>> timer.report()
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[stage] += time.perf_counter() - t0
            self.counts[stage] += 1

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


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` trace of the block, CPU activities and, with a
    card, CUDA ones; written to ``logdir/trace.json`` (open it in Perfetto
    or ``chrome://tracing``)."""
    import torch

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
