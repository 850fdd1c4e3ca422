"""host_wait_ms_per_frame (coupled step): the program's deliberate waits
for the card (``wait`` spans: ``utils/device.host_wait``, ``to_host``,
``PendingRead.read``), summed over the window and per window frame, in ms,
from the program's tracer (``perfbench/spans.py``)."""

from perfbench import spans

at_open, at_close = spans.at_open, spans.at_close


def read(run):
    w = spans.window(run)
    return None if w is None else spans.per(w.total_s("wait"), w.frames)
