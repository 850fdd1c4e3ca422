"""The program's own spans and counters over a traced run's window, for the
per-layer metrics that read them (``dbaf_tpu_torch.utils.profiling``:
``TRACER``, switched on by ``set_tracing``).

Each such metric's reader calls :func:`at_open` and :func:`at_close` from its
own; the first call of :func:`at_open` switches the tracer on and marks where
its ring and its counters stand, the first of :func:`at_close` takes the
window's spans, and the others find them.  The tracer stays on through the
profiled frames, so their ``torch.profiler`` trace holds the program's
stages as host ranges, which the breakdown's idle gaps can be named by.  A
program without the tracer leaves no mark, and every reader returns None.

Stages (the port's span sites): ``track`` (the frame's root), ``gate``,
``sensors``, ``select``, ``step``, ``round``, ``lm``, ``drain`` (with the
frame whose step it drains as its ``cause``) and ``wait``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _profiling():
    from dbaf_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "set_tracing") else None


def at_open(run):
    if "spans" in run.state:
        return
    run.state["spans"] = s = {}
    p = _profiling()
    if p is not None:
        s["open"] = p.set_tracing(True).mark()


def at_close(run):
    s = run.state.get("spans", {})
    if "open" in s and "window" not in s:
        tracer = _profiling().TRACER
        s["window"] = Window(tracer, s["open"], tracer.mark())


class Window:
    """The spans of the window's frames (``frames`` of them), taken when the
    window closes; the ring's later spans finish the work of its last
    frames (:meth:`pose_lags_s`)."""

    def __init__(self, tracer, opened: dict, closed: dict):
        self.tracer, self.closed = tracer, closed
        self.frames = closed["frame"] - opened["frame"]
        self.syncs = closed["syncs"] - opened["syncs"]
        sp = tracer.spans(opened["seq"])
        inside = (sp["frame"] > opened["frame"]) & (sp["frame"] <= closed["frame"])
        self.sp = {k: v[inside] for k, v in sp.items()}

    def _of(self, stage: str):
        return self.sp["stage"] == stage

    def count(self, stage: str) -> int:
        return int(self._of(stage).sum())

    def total_s(self, stage: str) -> float:
        m = self._of(stage)
        return float((self.sp["end"][m] - self.sp["start"][m]).sum())

    def self_s(self, stage: str) -> float:
        return float(self.sp["self"][self._of(stage)].sum())

    def pose_lags_s(self) -> np.ndarray:
        """Each window frame's seconds from its ``track`` start until its
        pose is on the host: the end of the ``drain`` whose cause it is
        (the asynchronous step; the last frame's drains in the first
        profiled frame), else the end of its own ``track``."""
        m = self._of("track")
        frame, start, end = self.sp["frame"][m], self.sp["start"][m], self.sp["end"][m]
        later = self.tracer.spans(self.closed["seq"])
        drained = {}
        for sp in (self.sp, later):
            d = sp["stage"] == "drain"
            drained.update(zip(sp["cause"][d].tolist(), sp["end"][d].tolist()))
        done = np.array([drained.get(f, e) for f, e in zip(frame.tolist(), end.tolist())])
        return done - start


def window(run) -> Optional[Window]:
    w = run.state.get("spans", {}).get("window")
    return w if w is not None and w.frames > 0 else None


def per(value: float, n: int) -> Optional[float]:
    """``value`` in ms over ``n``; None where ``n`` is 0."""
    return 1e3 * value / n if n else None
