"""The port's tracer (``dbaf_tpu_torch/utils/profiling.py``: ``StageTimer``,
``TRACER``, ``set_tracing``): spans nest with their parents and frame ids,
a drain carries its cause, self time leaves the children out, the ring wraps
at its cap, a span site with the tracer off records nothing, keeps no
memory and enters no ``record_function``, and the count of unplanned
synchronisations takes every occurrence inside a frame and none inside a
deliberate wait.  CUDA's sync debug warnings are raised here by hand: the
CPU has no synchronising call."""

import gc
import tracemalloc
import warnings

import numpy as np
import pytest
import torch

from dbaf_tpu_torch.utils import device
from dbaf_tpu_torch.utils import profiling as P


@pytest.fixture
def tracer():
    """The process-wide tracer, on, from a clean ring; off again after."""
    P.TRACER.reset()
    yield P.set_tracing(True)
    P.set_tracing(False)
    P.TRACER.reset()


def _clock(monkeypatch, readings):
    it = iter(readings)
    monkeypatch.setattr(P.time, "perf_counter", lambda: next(it))


def _frame(t, with_drain_of=None):
    with t("track", root=True):
        with t("gate"):
            with t("wait"):
                with t("wait"):  # a wait inside a wait: counted once
                    pass
        with t("step"):
            with t("round"):
                pass
            with t("lm"):
                with t("wait"):
                    pass
            if with_drain_of is not None:
                with t("drain", cause=with_drain_of):
                    with t("wait"):
                        pass


def test_spans_nest_with_their_parents_and_frames():
    t = P.StageTimer()
    _frame(t)
    _frame(t, with_drain_of=0)
    sp = t.spans()
    stages = list(sp["stage"])  # in the order the spans opened
    assert stages == ["track", "gate", "wait", "step", "round", "lm", "wait",
                      "track", "gate", "wait", "step", "round", "lm", "wait", "drain", "wait"]
    assert sp["seq"].tolist() == list(range(16)) and t.seq == 16 and t.frame == 1
    assert sp["parent"].tolist() == [-1, 0, 1, 0, 3, 3, 5, -1, 7, 8, 7, 10, 10, 12, 10, 14]
    assert sp["frame"].tolist() == [0] * 7 + [1] * 9
    # the drain carries the frame whose step it finishes; no other span has a cause
    assert sp["cause"].tolist() == [-1] * 14 + [0, -1]
    assert np.all(sp["end"] >= sp["start"])


def test_self_time_leaves_the_children_out(monkeypatch):
    t = P.StageTimer()
    # track [0, 10]: gate [1, 4] with wait [2, 3.5], step [5, 9] with round [6, 7]
    _clock(monkeypatch, [0.0, 1.0, 2.0, 3.5, 4.0, 5.0, 6.0, 7.0, 9.0, 10.0])
    with t("track", root=True):
        with t("gate"):
            with t("wait"):
                pass
        with t("step"):
            with t("round"):
                pass
    sp = t.spans()
    got = dict(zip(sp["stage"], sp["self"]))
    assert got == pytest.approx(dict(track=3.0, gate=1.5, wait=1.5, step=3.0, round=1.0))
    assert dict(t.totals) == pytest.approx(got)
    assert "track: 3000.0 ms total, 3000.0 ms/call x1" in t.report().splitlines()


def test_the_ring_wraps_at_its_cap():
    t = P.StageTimer()
    n = P.RING // 3 + 3  # frames of three spans: the ring wraps
    for k in range(n):
        with t("track", root=True):
            with t("gate"):
                pass
            with t("step"):
                pass
    assert t.seq == 3 * n and t.counts["track"] == n
    sp = t.spans()
    assert sp["seq"].tolist() == list(range(3 * n - P.RING, 3 * n))  # the newest RING
    assert list(sp["stage"][-6:]) == ["track", "gate", "step"] * 2
    assert sp["frame"].tolist()[-6:] == [n - 2] * 3 + [n - 1] * 3
    assert sp["parent"].tolist()[-3:] == [-1, 3 * n - 3, 3 * n - 3]
    assert t.spans(since=3 * n - 2)["seq"].tolist() == [3 * n - 2, 3 * n - 1]
    assert t.spans(since=0)["seq"][0] == 3 * n - P.RING  # what was overwritten is gone
    # an open span is not in the snapshot
    with t("track", root=True):
        assert t.spans(since=3 * n - 1)["seq"].tolist() == [3 * n - 1]


def test_an_off_site_records_and_allocates_nothing(monkeypatch):
    P.set_tracing(False)
    t = P.TRACER
    seq, frame = t.seq, t.frame

    def no_range(*a, **k):
        raise AssertionError("record_function entered with the tracer off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", no_range)
    monkeypatch.setattr(torch._C._autograd, "_profiler_enabled", lambda: True)

    def sites(n):
        for k in range(n):
            with t("track", root=True):
                with t("gate"):
                    with t("wait"):
                        pass
                with t("drain", cause=k):
                    pass

    sites(100)  # warm
    gc.collect()
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        sites(10000)
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # 40,000 sites ran: nothing kept, nothing that grows with the sites (an
    # empty loop of as many trips reads about as much)
    assert after - before < 1024 and peak - before < 2048
    assert (t.seq, t.frame) == (seq, frame)
    assert not t.totals and t("gate") is P._OFF


def test_the_profiler_sees_the_spans_while_it_records(tracer):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _frame(tracer, with_drain_of=0)
    names = {e.name for e in prof.events()}
    assert {"track", "gate", "step", "round", "lm", "drain", "wait"} <= names
    calls = []
    real = torch.autograd.profiler.record_function
    torch.autograd.profiler.record_function = lambda name: calls.append(name) or real(name)
    try:
        _frame(tracer)  # not recording: no range
    finally:
        torch.autograd.profiler.record_function = real
    assert calls == []


def _sync_warning():
    warnings.warn(P.SYNC_WARNING + " (Triggered internally at CUDAFunctions.cpp)", UserWarning)


def test_the_sync_counter_counts_every_occurrence_and_exempts_waits(monkeypatch, capsys):
    shown = []
    monkeypatch.setattr(warnings, "showwarning", lambda *a, **k: shown.append(str(a[0])))
    P.TRACER.reset()
    t = P.set_tracing(True)
    try:
        _sync_warning()  # outside a frame: the benchmark's own read, not the program's
        with t("track", root=True):
            for _ in range(3):  # one call site, three occurrences
                _sync_warning()
            with device.host_wait():
                _sync_warning()
            real = device._first_rank_value

            def read_with_sync(x):
                _sync_warning()
                return real(x)

            monkeypatch.setattr(device, "_first_rank_value", read_with_sync)
            assert device.to_host(torch.ones(())) == 1.0
            monkeypatch.setattr(device, "_first_rank_value", real)
            pending = device.PendingRead(torch.ones(2))
            monkeypatch.setattr(device.PendingRead, "landed",
                                lambda self: (_sync_warning(), self.host.numpy().copy())[1])
            assert pending.read().tolist() == [1.0, 1.0]
            with t("step"):
                _sync_warning()
            warnings.warn("another warning", UserWarning)
    finally:
        P.set_tracing(False)
    assert t.syncs == 4
    (site, n), = t.sync_sites.items()
    assert n == 4 and site == f"{__file__}:{_sync_warning.__code__.co_firstlineno + 1}"
    assert shown == ["another warning"]  # other warnings pass; the sync ones are silent
    assert P.SYNC_WARNING not in capsys.readouterr().err
    with t("track", root=True):
        with pytest.warns(UserWarning, match=P.SYNC_WARNING):  # off: not caught
            _sync_warning()
    assert t.syncs == 4
    P.TRACER.reset()
