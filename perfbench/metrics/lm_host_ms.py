"""lm_host_ms (factor graph, one LM pass, ``dg.coupled_rounds_body`` in
``slam/coupled_fused.py::run_coupled_rounds``): the mean self time of the
window's ``lm`` spans, in ms (the synchronous flow's blocking LM polls are
their ``wait`` children, left out), from the program's tracer
(``perfbench/spans.py``)."""

from perfbench import spans

at_open, at_close = spans.at_open, spans.at_close


def read(run):
    w = spans.window(run)
    return None if w is None else spans.per(w.self_s("lm"), w.count("lm"))
