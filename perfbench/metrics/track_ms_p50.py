"""track_ms_p50 (facade, ``DBAFusion.track``): the median ``track`` call time
of the traced run's window, host clock, in ms."""

import numpy as np


def read(run):
    return float(np.median(np.asarray(run.window["frame_s"]) * 1e3))
