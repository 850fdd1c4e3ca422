"""lm_linearize_kernel_share (factor graph, ``fusion/device_graph.py::lm_optimize``):
of the LM iterations the traced window launched, masked ones included, the
share whose relinearization was the hand kernel (``csrc/fg_linearize.cu``),
in %, from the program's counters (``TRACER.lm_launched``,
``TRACER.lm_kernel_linearized`` in ``utils/profiling.py``, counted whether
tracing is on or off), read at the window's ends.  A program without the
counters reads nothing."""


def _counters():
    from dbaf_tpu_torch.utils.profiling import TRACER

    m = TRACER.mark()
    return (m["lm_launched"], m["lm_kernel_linearized"]) if "lm_kernel_linearized" in m else None


def at_open(run):
    run.state["lm_linearize_kernel_share"] = {"open": _counters()}


def at_close(run):
    run.state["lm_linearize_kernel_share"]["close"] = _counters()


def read(run):
    s = run.state.get("lm_linearize_kernel_share", {})
    if s.get("open") is None or s.get("close") is None:
        return None
    launched, kernel = (c - o for c, o in zip(s["close"], s["open"]))
    return 100.0 * kernel / launched if launched else None
