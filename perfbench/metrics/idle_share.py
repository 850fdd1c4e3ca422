"""idle_share (device): the share of the profiled frames' wall time in which
no kernel ran on the card, from the profiler's kernel intervals merged on
the timeline, in %."""


def read(run):
    p = run.profile
    if not p or p["wall_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
