"""select_host_ms (coupled step, the edge lifecycle: ``rm_factors`` and
``add_proximity_factors`` in ``Frontend._update``, or the asynchronous
step's device selection in ``slam/coupled_async.py::coupled_step``): the
``select`` spans' time per keyframe step (``step`` span) of the window, in
ms, from the program's tracer (``perfbench/spans.py``)."""

from perfbench import spans

at_open, at_close = spans.at_open, spans.at_close


def read(run):
    w = spans.window(run)
    return None if w is None else spans.per(w.total_s("select"), w.count("step"))
