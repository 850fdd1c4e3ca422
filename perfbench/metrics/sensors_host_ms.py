"""sensors_host_ms (factor graph, ``slam/frontend.py``
``Frontend._ingest_sensors``: IMU preintegration, GNSS and odometry rows):
the ``sensors`` spans' time per keyframe step (``step`` span) of the
window, in ms, from the program's tracer (``perfbench/spans.py``)."""

from perfbench import spans

at_open, at_close = spans.at_open, spans.at_close


def read(run):
    w = spans.window(run)
    return None if w is None else spans.per(w.total_s("sensors"), w.count("step"))
