"""A small traced run of one benchmark cell on the CPU (``perfbench/tests/tiny.py``:
the cell's configuration and traffic at 64 x 128, the kernels' plain
versions) with the program's tracer, for ``test_torch_tracer_bench_*.py``."""

import math

from dbaf_tpu_torch.utils import profiling

# the per-layer metrics that read the program's spans and sync counter
SPAN_METRICS = ("gate_host_ms", "sensors_host_ms", "select_host_ms", "step_self_ms",
                "round_host_ms", "lm_host_ms", "host_wait_ms_per_frame", "pose_lag_ms_p50",
                "implicit_syncs_per_frame")


def traced_run(cell):
    """The result line's metrics of a ``--trace 1`` run, and the spans of
    its window and after (the tracer is switched off again)."""
    from perfbench.tests import tiny

    profiling.TRACER.reset()
    try:
        result = tiny.run_small(cell, seconds=3.0, trace=True)
        spans = profiling.TRACER.spans()
    finally:
        profiling.set_tracing(False)
        profiling.TRACER.reset()
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert result["correct"]
    for name in SPAN_METRICS:
        assert name in metrics, name
        assert math.isfinite(metrics[name]) and metrics[name] >= 0, (name, metrics[name])
    return metrics, spans
