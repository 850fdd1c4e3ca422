"""round_host_ms (update round, ``UpdateStep.update_round`` in
``slam/coupled_fused.py::run_coupled_rounds``: reproject, K1, ConvGRU,
heuristics): the mean self time of the window's ``round`` spans, in ms,
from the program's tracer (``perfbench/spans.py``)."""

from perfbench import spans

at_open, at_close = spans.at_open, spans.at_close


def read(run):
    w = spans.window(run)
    return None if w is None else spans.per(w.self_s("round"), w.count("round"))
