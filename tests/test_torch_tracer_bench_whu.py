"""The tracer's metrics in a small ``--trace 1`` run of ``whu-ms.drive`` (the
synchronous coupled flow): all nine are there, finite and >= 0, the blocking
LM polls are ``wait`` spans inside ``lm``, no drain runs, and a pose is on
the host when its own ``track`` returns."""

from tests.tracer_cells import traced_run


def test_whu_traced_run_reports_the_span_metrics():
    m, sp = traced_run("whu-ms.drive")
    assert not (sp["stage"] == "drain").any()
    parent = dict(zip(sp["seq"].tolist(), sp["stage"]))
    waits = [parent.get(p) for s, p in zip(sp["stage"], sp["parent"].tolist()) if s == "wait"]
    assert "lm" in waits and "gate" in waits
    assert m["host_wait_ms_per_frame"] > 0 and m["lm_host_ms"] > 0 and m["sensors_host_ms"] > 0
    assert m["pose_lag_ms_p50"] <= m["track_ms_p50"]
