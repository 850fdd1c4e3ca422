"""corr_roofline (kernels: ``csrc/corr_fused_xy.cu``): the least time the
update rounds' correlation work of the profiled frames needs on the card
(operations or bytes, ``perfbench/counts.py``) over the device time of the
kernels that did it, in %.

The work is counted from the system's state, not from the kernels: the
window's edge-rounds per frame times the profiled frames.  The kernels'
time is the profiler's, summed over the names below; where none ran, the
metric is left out."""

from perfbench import counts

KERNELS = ("corr_fused_xy",)


def read(run):
    p = run.profile
    if not p or not run.work["frames"]:
        return None
    seconds = sum(s for name, s in p["kernels"].items() if any(k in name for k in KERNELS))
    if seconds <= 0:
        return None
    H, W = run.cfg.image_size
    H8, W8 = H // 8, W // 8
    edge_rounds = run.work["edge_rounds"] / run.work["frames"] * run.profiled_frames
    least, _ = counts.least_seconds(edge_rounds * counts.corr_flops(H8, W8),
                                    edge_rounds * counts.corr_bytes(H8, W8))
    return 100.0 * least / seconds
