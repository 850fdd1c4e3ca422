"""The device LM on the card (``fusion/device_graph.py::lm_optimize``):
iterations replayed from the captured CUDA graphs against the same loop
launched op by op, on ``tests/test_torch_device_graph.py``'s window (8
frames, a marginal, odometry) and on 20 frames with GNSS and odometry rows
(the cells' ``sensors.fg_cap``), under a blocking and a non-blocking poll.

Both give the same iteration count and the same state, bit for bit or
within 1e-6 of each field's scale; the capture and the replays make no
synchronising call (CUDA's sync debug mode ``"error"``); a second pass of
the same key replays without capturing again.  Prints each case's numbers
and the card's time for one replayed iteration against the op-by-op one.

Needs a CUDA device; skipped without one.  Imports neither JAX nor the JAX
package."""

import time

import pytest
import torch

from dbaf_tpu_torch.fusion import device_graph as tdg
from dbaf_tpu_torch.utils import profiling
from dbaf_tpu_torch.utils.device import FlagPoll, configure_cuda_numerics
from lm_windows import lm_inputs  # tests/ is on the path (pytest's rootdir-less import)

WINDOWS = {"nw8": dict(nw=8, n=5, seed=7), "nw20_gnss": dict(nw=20, n=14, seed=3, gnss=True)}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs are captured on the card")
    configure_cuda_numerics()
    return torch.device("cuda")


def _eager(monkeypatch):
    """The loop launched op by op on the card."""
    monkeypatch.setattr(tdg, "_lm_pass", tdg._EagerLM)


def _counts():
    m = profiling.TRACER.mark()
    return m["lm_launched"], m["lm_replayed"]


def _solve(args, blocking):
    c0 = _counts()
    st, (err, its) = tdg.lm_optimize(*args, poll=FlagPoll(blocking=blocking))
    launched, replayed = (a - b for a, b in zip(_counts(), c0))
    return st, err, int(its), launched, replayed


@pytest.mark.cuda
@pytest.mark.parametrize("blocking", [True, False], ids=["blocking", "nonblocking"])
@pytest.mark.parametrize("window", WINDOWS)
def test_replayed_lm_matches_the_eager_loop(dev, window, blocking, monkeypatch):
    args = lm_inputs(**WINDOWS[window], device=dev)
    st, err, its, launched, replayed = _solve(args, blocking)
    with monkeypatch.context() as m:
        _eager(m)
        st_e, err_e, its_e, launched_e, replayed_e = _solve(args, blocking)
    assert replayed == launched and replayed_e == 0
    assert its == its_e and 1 < its < 24
    assert launched <= its + 2
    if blocking:
        assert launched == its
    worst = 0.0
    for a, b in zip((*st[:4], err), (*st_e[:4], err_e)):
        scale = max(float(b.abs().max()), 1e-30)
        worst = max(worst, float((a - b).abs().max()) / scale)
    assert worst <= 1e-6
    assert torch.equal(st.valid, st_e.valid)
    print(f"[lm-graph] {window} {'blocking' if blocking else 'nonblocking'}: iterations "
          f"{its} (eager {its_e}), launched {launched} (eager {launched_e}), replayed "
          f"{replayed}, worst relative difference {worst:.3e}, bitwise "
          f"{all(torch.equal(a, b) for a, b in zip(st[:4], st_e[:4]))}")


@pytest.mark.cuda
@pytest.mark.parametrize("window", WINDOWS)
def test_capture_and_replays_make_no_synchronising_call(dev, window):
    args = lm_inputs(**WINDOWS[window], device=dev)
    tdg._REPLAYED.clear()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, (_, its) = tdg.lm_optimize(*args, poll=FlagPoll())  # captures, then replays
        st2, (_, its2) = tdg.lm_optimize(*args, poll=FlagPoll())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(tdg._REPLAYED) == 1
    assert int(its) == int(its2) > 1
    for a, b in zip(st[:4], st2[:4]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_second_pass_of_the_key_replays_without_capturing(dev, monkeypatch):
    captures = []
    real = tdg._ReplayedLM._capture
    monkeypatch.setattr(tdg._ReplayedLM, "_capture",
                        staticmethod(lambda fn: captures.append(fn) or real(fn)))
    tdg._REPLAYED.clear()
    args = lm_inputs(**WINDOWS["nw20_gnss"], device=dev)
    _, _, its1, launched1, replayed1 = _solve(args, True)
    (key, lm), = tdg._REPLAYED.items()
    assert len(captures) == 2  # the start and the iteration
    _, _, its2, launched2, replayed2 = _solve(args, True)
    assert len(captures) == 2 and tdg._REPLAYED == {key: lm}
    assert its1 == its2 == launched2 == replayed2


@pytest.mark.cuda
def test_one_replayed_iteration_against_one_launched_op_by_op(dev):
    """The card's time for one iteration replayed, and the host's and the
    card's for one launched op by op, on the 20-frame window (CUDA events;
    masked iterations, the same work as realized ones)."""
    args = lm_inputs(**WINDOWS["nw20_gnss"], device=dev)
    tdg.lm_optimize(*args)
    lm = tdg._lm_pass(tdg._lm_tensors(*args), 1e-5, (10.0, 1e5, 1e-5, 1e-5))
    eager = tdg._EagerLM(tdg._lm_tensors(*args), 1e-5, (10.0, 1e5, 1e-5, 1e-5))
    out = {}
    for name, it in (("replayed", lm.iterate), ("eager", eager.iterate)):
        for _ in range(3):
            it()
        torch.cuda.synchronize()
        n = 50
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        for _ in range(n):
            it()
        e1.record()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
        torch.cuda.synchronize()
        out[name] = (e0.elapsed_time(e1) / n, host_ms)
    print(f"[lm-graph] one iteration at NW=20, card ms (host ms to launch): replayed "
          f"{out['replayed'][0]:.4f} ({out['replayed'][1]:.4f}), op by op "
          f"{out['eager'][0]:.4f} ({out['eager'][1]:.4f}); "
          f"{torch.cuda.get_device_name(0)}")
    assert out["replayed"][1] < out["eager"][1]
