"""step_mfu (device, the whole step): the network's and the correlation's
operations for the traced window's work (``perfbench/counts.py``: every
frame's gate, every admitted frame's context encoder, every edge-round's
update and correlation) over the window's seconds at the card's bf16 dense
peak, in %."""

from perfbench import counts


def read(run):
    w = run.work
    if not w["frames"] or not run.window.get("seconds"):
        return None
    H, W = run.cfg.image_size
    flops = counts.work_flops(H, W, w["frames"], w["admitted"], w["edge_rounds"])
    return 100.0 * flops / (run.window["seconds"] * counts.PEAK_BF16_FLOPS)
