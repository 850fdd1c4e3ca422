"""lm_graph_share (factor graph, ``fusion/device_graph.py::lm_optimize``): of
the LM iterations the traced window launched, masked ones included, the
share that were replays of the captured CUDA graph, in %, from the
program's counters (``TRACER.lm_launched``, ``TRACER.lm_replayed`` in
``utils/profiling.py``, counted whether tracing is on or off), read at the
window's ends.  A program without the counters reads nothing."""


def _counters():
    from dbaf_tpu_torch.utils.profiling import TRACER

    m = TRACER.mark()
    return (m["lm_launched"], m["lm_replayed"]) if "lm_replayed" in m else None


def at_open(run):
    run.state["lm_graph_share"] = {"open": _counters()}


def at_close(run):
    run.state["lm_graph_share"]["close"] = _counters()


def read(run):
    s = run.state.get("lm_graph_share", {})
    if s.get("open") is None or s.get("close") is None:
        return None
    launched, replayed = (c - o for c, o in zip(s["close"], s["open"]))
    return 100.0 * replayed / launched if launched else None
