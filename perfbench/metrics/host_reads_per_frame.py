"""host_reads_per_frame (coupled step): blocking device-to-host reads over
the traced window's frames, from the port's own counter
(``dbaf_tpu_torch.utils.device.HOST_READS``, bumped at the one place reads
happen)."""

from dbaf_tpu_torch.utils import device


def at_open(run):
    run.state["host_reads"] = {"r0": device.HOST_READS["count"]}


def at_close(run):
    run.state["host_reads"]["r1"] = device.HOST_READS["count"]


def read(run):
    s = run.state.get("host_reads")
    if not s or "r1" not in s or not run.window.get("frames"):
        return None
    return (s["r1"] - s["r0"]) / run.window["frames"]
