"""gate_host_ms (gate and admission, ``slam/motion_filter.py``
``MotionFilter.track``): the ``gate`` spans' self time (their ``wait``
children, the admission read, left out) per window frame, in ms, from the
program's tracer (``perfbench/spans.py``)."""

from perfbench import spans

at_open, at_close = spans.at_open, spans.at_close


def read(run):
    w = spans.window(run)
    return None if w is None else spans.per(w.self_s("gate"), w.frames)
