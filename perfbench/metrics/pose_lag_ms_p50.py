"""pose_lag_ms_p50 (facade, ``DBAFusion.track``): the median over window
frames of the time from a frame's ``track`` start until its pose is on the
host: the end of the ``drain`` whose cause it is on the asynchronous
coupled pipeline (one step later), else the end of its own ``track``; in
ms, from the program's tracer (``perfbench/spans.py``)."""

import numpy as np

from perfbench import spans

at_open, at_close = spans.at_open, spans.at_close


def read(run):
    w = spans.window(run)
    return None if w is None else float(np.median(w.pose_lags_s()) * 1e3)
