"""lm_launched_per_pass (factor graph, ``fusion/device_graph.py::lm_optimize``):
LM iterations launched per LM pass over the traced window, masked ones
included, beside the realized ``lm_iters_per_pass``: a blocking poll
launches the realized count, a non-blocking one at most one iteration more
a pass.  From the program's counters (``TRACER.lm_launched``,
``TRACER.lm_passes`` in ``utils/profiling.py``, counted whether tracing is
on or off), read at the window's ends; the passes are every pass launched,
those of rounds a cull undid too.  A program without the counters reads
nothing."""


def _counters():
    from dbaf_tpu_torch.utils.profiling import TRACER

    m = TRACER.mark()
    return (m["lm_launched"], m["lm_passes"]) if "lm_passes" in m else None


def at_open(run):
    run.state["lm_launched_per_pass"] = {"open": _counters()}


def at_close(run):
    run.state["lm_launched_per_pass"]["close"] = _counters()


def read(run):
    s = run.state.get("lm_launched_per_pass", {})
    if s.get("open") is None or s.get("close") is None:
        return None
    launched, passes = (c - o for c, o in zip(s["close"], s["open"]))
    return launched / passes if passes else None
