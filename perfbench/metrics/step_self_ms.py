"""step_self_ms (coupled step: ``CovisibleGraph.update_coupled_mega``, or
``CoupledAsync.step`` with its pack, upload, launches and replayed rollup):
the ``step`` spans' self time, less their ``select``, ``round``, ``lm``,
``drain`` and ``wait`` children, per keyframe step of the window, in ms,
from the program's tracer (``perfbench/spans.py``)."""

from perfbench import spans

at_open, at_close = spans.at_open, spans.at_close


def read(run):
    w = spans.window(run)
    return None if w is None else spans.per(w.self_s("step"), w.count("step"))
