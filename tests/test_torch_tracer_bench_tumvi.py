"""The tracer's metrics in a small ``--trace 1`` run of ``tumvi-vio.handheld``
(the zero-pull coupled pipeline): all nine are there, finite and >= 0, every
drain names the frame before it as its cause (a pack drains one step late),
and so a pose reaches the host after its own ``track`` returned."""

from tests.tracer_cells import traced_run


def test_tumvi_traced_run_reports_the_span_metrics():
    m, sp = traced_run("tumvi-vio.handheld")
    drain = sp["stage"] == "drain"
    assert drain.sum() >= 3
    assert (sp["cause"][drain] == sp["frame"][drain] - 1).all()
    assert (sp["cause"][~drain] == -1).all()
    assert m["pose_lag_ms_p50"] > m["track_ms_p50"]
    assert m["step_self_ms"] > 0 and m["select_host_ms"] > 0 and m["round_host_ms"] > 0
