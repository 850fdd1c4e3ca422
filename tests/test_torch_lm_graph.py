"""The device LM's loop (``fusion/device_graph.py::lm_optimize``) on the CPU:
its bound on the run-ahead of a non-blocking poll, the eager path the CPU
takes (the plain ``linearize``, never the hand kernel), and the counters of
launched, replayed and kernel-relinearized iterations with the three
per-layer metrics that read them (``perfbench/metrics/lm_graph_share.py``,
``lm_launched_per_pass.py``, ``lm_linearize_kernel_share.py``).

The run-ahead bound is held with a poll whose posts land only when waited
on, the slowest card there can be: the loop must launch at most one
iteration past the realized count (two is the bound asked of it) and return the
blocking poll's state and count, bit for bit, since masked iterations write
nothing.  The windows: ``tests/test_torch_device_graph.py``'s (8 frames, a
marginal, odometry) and 20 frames with GNSS and odometry rows (the cells'
``sensors.fg_cap``)."""

import types

import pytest
import torch

from dbaf_tpu_torch.fusion import device_graph as tdg
from dbaf_tpu_torch.utils import profiling
from dbaf_tpu_torch.utils.device import FlagPoll
from perfbench import harness
from tests.lm_windows import lm_inputs

WINDOWS = {"nw8": dict(nw=8, n=5, seed=7), "nw20_gnss": dict(nw=20, n=14, seed=3, gnss=True)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Landing:
    """A post's event that completes only once waited on."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


class WaitedPoll(FlagPoll):
    """A non-blocking poll whose posts answer only when waited on."""

    def post(self, flag):
        self.posted += 1
        self._posts.append((flag.clone(), _Landing()))


def _counts():
    m = profiling.TRACER.mark()
    return {k: m[k] for k in ("lm_passes", "lm_launched", "lm_replayed")}


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items()}


@pytest.mark.parametrize("window", WINDOWS)
def test_run_ahead_is_bounded_and_changes_nothing(window):
    args = lm_inputs(**WINDOWS[window])
    c0 = _counts()
    ref, (err_ref, its_ref) = tdg.lm_optimize(*args)
    blocking = _delta(c0)
    poll = WaitedPoll()
    c1 = _counts()
    st, (err, its) = tdg.lm_optimize(*args, poll=poll)
    waited = _delta(c1)
    realized = int(its_ref)
    assert 1 < realized < 24
    # the blocking poll launches the realized count; the waited-on poll one
    # more: it waits for iteration k - 1's answer before launching k + 1
    assert blocking == dict(lm_passes=1, lm_launched=realized, lm_replayed=0)
    assert waited == dict(lm_passes=1, lm_launched=realized + 1, lm_replayed=0)
    assert poll.posted == realized + 1 <= realized + 2
    assert int(its) == realized and torch.equal(err, err_ref)
    for a, b in zip(st, ref):
        assert torch.equal(a, b)


def test_the_cpu_takes_the_eager_path_and_never_captures(monkeypatch):
    def no_capture(*a, **k):
        raise AssertionError("the CPU captured a CUDA graph")

    monkeypatch.setattr(tdg, "_ReplayedLM", no_capture)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_capture)
    cached = dict(tdg._REPLAYED)
    c0 = _counts()
    _, (_, its) = tdg.lm_optimize(*lm_inputs(**WINDOWS["nw8"]))
    assert _delta(c0) == dict(lm_passes=1, lm_launched=int(its), lm_replayed=0)
    assert tdg._REPLAYED == cached


def _stub_run():
    return types.SimpleNamespace(state={})


def _readers():
    return [harness.load_reader(n) for n in ("lm_graph_share", "lm_launched_per_pass")]


def test_the_counters_and_their_readers_on_a_stubbed_window(monkeypatch):
    share, per_pass = _readers()
    run = _stub_run()
    for mod in (share, per_pass):
        mod.at_open(run)
    args = lm_inputs(**WINDOWS["nw8"])
    _, (_, its_a) = tdg.lm_optimize(*args)
    _, (_, its_b) = tdg.lm_optimize(*args, poll=WaitedPoll())
    # the replays the card would have counted: two thirds of the launches
    launched = int(its_a) + int(its_b) + 1
    profiling.TRACER.lm_replayed += 2 * launched // 3
    for mod in (share, per_pass):
        mod.at_close(run)
    assert share.read(run) == pytest.approx(100.0 * (2 * launched // 3) / launched)
    assert per_pass.read(run) == pytest.approx(launched / 2)


def test_the_readers_read_nothing_without_the_counters_or_the_passes(monkeypatch):
    share, per_pass = _readers()
    run = _stub_run()
    for mod in (share, per_pass):  # a window without an LM pass
        mod.at_open(run)
        mod.at_close(run)
        assert mod.read(run) is None
    # a program without the counters (the tracer's mark has none of them)
    old = types.SimpleNamespace(mark=lambda: dict(seq=0, frame=-1, syncs=0))
    monkeypatch.setattr(profiling, "TRACER", old)
    run = _stub_run()
    for mod in (share, per_pass):
        mod.at_open(run)
        mod.at_close(run)
        assert mod.read(run) is None
    assert _stub_run().state == {} and share.read(_stub_run()) is None


@pytest.mark.parametrize("window", WINDOWS)
def test_the_cpu_relinearizes_with_the_plain_version(window):
    args = lm_inputs(**WINDOWS[window])
    assert all(torch.equal(a, b) for a, b in zip(tdg.linearize(*args), tdg.linearize_plain(*args)))
    m0, n0 = profiling.TRACER.mark(), tdg.LAUNCHES["fg_linearize"]
    _, (_, its) = tdg.lm_optimize(*args)
    m1 = profiling.TRACER.mark()
    assert m1["lm_launched"] - m0["lm_launched"] == int(its) > 1
    assert m1["lm_kernel_linearized"] == m0["lm_kernel_linearized"]
    assert tdg.LAUNCHES["fg_linearize"] == n0


# (iterations launched, of those relinearized by the kernel) between the
# window's marks, and the share the reader gives
SHARES = {"all": (41, 41, 100.0), "some": (12, 3, 25.0), "none": (7, 0, 0.0),
          "no_pass": (0, 0, None)}


class _Marks:
    """A tracer whose marks give the counters of a stubbed window."""

    def __init__(self, launched, kernel, with_counter=True):
        self.marks = [dict(seq=0, frame=-1, syncs=0, lm_passes=0, lm_launched=5,
                           lm_replayed=5, lm_kernel_linearized=5),
                      dict(seq=9, frame=3, syncs=0, lm_passes=2, lm_launched=5 + launched,
                           lm_replayed=5 + launched, lm_kernel_linearized=5 + kernel)]
        if not with_counter:  # the parent's tracer
            for m in self.marks:
                del m["lm_kernel_linearized"]

    def mark(self):
        return self.marks.pop(0)


@pytest.mark.parametrize("case", SHARES)
def test_the_kernel_share_reader_on_stubbed_marks(case, monkeypatch):
    launched, kernel, share = SHARES[case]
    reader = harness.load_reader("lm_linearize_kernel_share")
    monkeypatch.setattr(profiling, "TRACER", _Marks(launched, kernel))
    run = _stub_run()
    reader.at_open(run)
    reader.at_close(run)
    assert reader.read(run) == (None if share is None else pytest.approx(share))


def test_the_kernel_share_reader_reads_nothing_without_the_counter(monkeypatch):
    reader = harness.load_reader("lm_linearize_kernel_share")
    monkeypatch.setattr(profiling, "TRACER", _Marks(10, 10, with_counter=False))
    run = _stub_run()
    reader.at_open(run)
    reader.at_close(run)
    assert reader.read(run) is None and reader.read(_stub_run()) is None
