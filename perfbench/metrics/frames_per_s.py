"""frames_per_s: every frame whose ``track`` call returned in the window,
over the window's seconds (host clock; the window closes with the device
synchronised, so work still in flight is inside it)."""


def read(run):
    return run.window["frames"] / run.window["seconds"]
