"""The port's profiling helpers (``utils/profiling.py``): ``StageTimer``'s
report equals the JAX package's under a patched clock, ``get_logger`` writes
the ``dba_fusion`` log, and ``device_trace`` writes a Chrome trace on the CPU.
"""

import json
import logging
import os

import torch


def _drive(module, monkeypatch):
    clock = iter([0.0, 0.0125, 1.0, 1.5, 2.0, 2.0004, 3.0, 3.25])
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
    timer = module.StageTimer()
    for stage in ("update", "gate", "update", "gate"):
        with timer(stage):
            pass
    return timer


def test_stage_timer_report_matches_jax(monkeypatch):
    from dbaf_tpu.utils import profiling as jp

    from dbaf_tpu_torch.utils import profiling as pp

    port, ref = _drive(pp, monkeypatch), _drive(jp, monkeypatch)
    assert port.report() == ref.report()
    assert port.report().splitlines() == ["gate: 750.0 ms total, 375.0 ms/call x2",
                                          "update: 12.9 ms total, 6.4 ms/call x2"]
    port.reset()
    assert port.report() == ""


def test_get_logger_writes_the_file(tmp_path):
    from dbaf_tpu_torch.utils.profiling import get_logger

    logger = logging.getLogger("dba_fusion")
    saved = list(logger.handlers)
    for h in saved:
        logger.removeHandler(h)
    try:
        path = tmp_path / "dbaf.log"
        log = get_logger(str(path))
        assert log is logger and get_logger() is log  # one handler, kept
        log.info("keyframe %d", 7)
        for h in log.handlers:
            h.flush()
        assert "dba_fusion - INFO - keyframe 7" in path.read_text()
    finally:
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
        for h in saved:
            logger.addHandler(h)


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    from dbaf_tpu_torch.utils.profiling import device_trace

    logdir = tmp_path / "trace"
    with device_trace(str(logdir)):
        x = torch.randn(64, 64)
        (x @ x).sum()
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
