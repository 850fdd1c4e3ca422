"""frame_ms_p90 (facade, ``DBAFusion.track``): the 90th percentile of every
``track`` call time in the traced run's window, host clock, in ms (numpy's
linear interpolation between order statistics)."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.window["frame_s"]) * 1e3, 90))
