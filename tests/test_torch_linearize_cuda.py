"""The factor graph's hand kernel on the card (``csrc/fg_linearize.cu``, reached
through ``fusion/device_graph.py::linearize``) against its plain version
(``linearize_plain``) on the same card, on the windows of
``tests/lm_windows.py``: 8 frames (a marginal, odometry), 20 frames with GNSS
(the cells' ``sensors.fg_cap``), the kernel's smallest and a wide window (2
and 64 frames), and the 8- and 20-frame windows settled as the cells' later
LM iterations find them (``settled_inputs``: positions tens of metres out,
every term's gradient cancelling to a small b); with and without the
marginal, with ``hold_empty`` both ways, and with the device
marginalization's cut masks.

Tolerances, each with its reason:

* H, per entry: ``|k - p| <= 1e-5 |p| + 1e-6 sqrt(|p_ii p_jj|)``.  The
  relative part holds every entry above 1e-6 of its row's diagonal to its
  own size; a tolerance relative to max |H| would hide errors, since IMU
  information spans about ten orders of magnitude.  The second part is f32
  rounding of the terms that cancel into an entry: every term is a positive
  semidefinite block, so none exceeds sqrt(H_ii H_jj) at (i, j), and where
  they cancel to a small entry both f32 versions keep only their rounding
  (on the CPU, entries at 2e-6 of their row's diagonal differ from an f64
  plain version by 47 % in the plain f32 version itself).
* b, per entry, and err: ``|k - p| <= 1e-5 |p| + 8 eps32 m``, with m the
  size of the terms behind the entry (``lm_windows.rounding_scale``: each
  factor's |J|^T |L| (|r| + s), s the magnitude of the computed operands its
  residual subtracts, and the marginal's and visual system's |v| + |H|
  (|dvec| + s)).  Both versions evaluate the same formulas in f32, and a
  residual that cancels to millimetres under an information of 1e10 leaves
  b with an f32 error far above 1e-5 of itself in either version: in the
  settled windows the plain version's b is 2e-3 to 5e-3 from an f64
  evaluation of the same f32 inputs (relative, by norm), and on the cells'
  own passes 1e-2 to 2e-2 at the median and up to 0.7.  The factor 8
  covers the roundings along the longest chain behind a term; measured,
  either version's error against the f64 evaluation, and their
  difference, reach at most 1.9 eps32 m on these windows and 1.0 on 120
  passes and 36 marginalizations of the three cells on an H100.
* Both versions against the f64 evaluation of the same inputs: each within
  8 eps32 m, per entry of b and for err, and the kernel's b no farther off
  than the plain version's by the root mean square over b's rows.
* The LM pass replayed with the kernel against the eager plain pass: final
  state within 1e-4 of each field's scale and error within 1e-3 relative
  (the two stop at the same fixed point within the LM's 1e-5 relative
  tolerance on the error), iteration counts within one.

Also: two launches on the same inputs give the same bits, capture and
replay make no synchronising call, the wrapper raises on what the kernel does not take,
and the card's times of ``linearize`` and of one replayed iteration at
NW = 20 with the plain version's beside them (``-s`` prints them).

Needs a CUDA device; skipped without one.  Imports neither JAX nor the JAX
package."""

import time

import pytest
import torch

from dbaf_tpu_torch.fusion import device_graph as tdg
from dbaf_tpu_torch.utils import profiling
from dbaf_tpu_torch.utils.device import FlagPoll, configure_cuda_numerics
# tests/ is on the path (pytest's rootdir-less import)
from lm_windows import (EPS32, ROUNDINGS, _f64, cut_masks, lm_inputs, rounding_scale,
                        settled_inputs, tolerance_ratios)

WINDOWS = {"nw8": dict(nw=8, n=5, seed=7), "nw20_gnss": dict(nw=20, n=14, seed=3, gnss=True),
           "nw2": dict(nw=2, n=2, seed=5), "nw64_gnss": dict(nw=64, n=40, seed=11, gnss=True),
           "nw8_settled": dict(nw=8, n=5, seed=7, settled=True),
           "nw20_gnss_settled": dict(nw=20, n=14, seed=3, gnss=True, settled=True)}
STEP = (10.0, 1e5, 1e-5, 1e-5)  # lm_optimize's lambda_factor, lambda_max and tolerances


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs on the card")
    configure_cuda_numerics()
    return torch.device("cuda")


_INPUTS = {}


def _inputs(window, dev):
    if window not in _INPUTS:
        kw = dict(WINDOWS[window])
        _INPUTS[window] = (settled_inputs if kw.pop("settled", False) else lm_inputs)(
            **kw, device=dev)
    return _INPUTS[window]


def _check(kernel, plain, args):
    """The kernel's (H, b, err) against the plain version's at the
    tolerances of the module docstring; a line of the ratios to them."""
    r = tolerance_ratios(kernel, plain, args)
    Hk, Hp = kernel[0].double(), plain[0].double()
    sig = Hp.abs() > 1e-6 * torch.diagonal(Hp).abs()[:, None]
    rel_sig = float(((Hk - Hp).abs() / Hp.abs().clamp_min(1e-30))[sig].max())
    assert torch.isfinite(kernel[0]).all() and torch.isfinite(kernel[1]).all()
    assert r["H"] <= 1.0 and r["b"] <= 1.0 and r["err"] <= 1.0, r
    return (f"H {r['H']:.3f} of its bound (entries above 1e-6 of the row's diagonal: largest "
            f"relative difference {rel_sig:.2e}), b {r['b']:.3f} and err {r['err']:.3f} of theirs")


def _case_args(window, case, dev):
    """linearize's arguments for a case of test_kernel_matches_the_plain_version."""
    st, pg, vH, vv, lR, lt, mgd = _inputs(window, dev)
    NW = st.R.shape[0]
    if case == "no_marginal":
        mgd = None
    if case == "marginalization":  # marginalize_window_body's call
        pg, lR, lt = cut_masks(pg, min(2, NW - 1)), st.R, st.t
    return (st, pg, vH, vv, lR, lt, mgd), case in ("full", "no_marginal")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full", "no_marginal", "no_hold", "marginalization"])
@pytest.mark.parametrize("window", WINDOWS)
def test_kernel_matches_the_plain_version(dev, window, case):
    args, hold = _case_args(window, case, dev)
    n0 = tdg.LAUNCHES["fg_linearize"]
    kernel = tdg.linearize(*args, hold)
    assert tdg.LAUNCHES["fg_linearize"] == n0 + 1
    plain = tdg.linearize_plain(*args, hold)
    torch.cuda.synchronize()
    print(f"[fg-linearize] {window} {case}: {_check(kernel, plain, args)}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full", "marginalization"])
@pytest.mark.parametrize("window", ["nw8", "nw20_gnss", "nw8_settled", "nw20_gnss_settled"])
def test_both_versions_within_f32_rounding_of_the_f64_evaluation(dev, window, case):
    """The kernel and the plain version against linearize_plain in f64 on the
    same (f32) inputs: each within 8 eps32 m per entry of b and for err,
    and the kernel's b no farther off than the plain version's by the root
    mean square of |b - b_f64| / (eps32 m) over b's rows.  err is one sum,
    rounded in both at 0.001-0.8 eps32 m_err here, either the nearer by
    case, so it is held to the bound alone.  Prints both versions' numbers."""
    args, hold = _case_args(window, case, dev)
    ref = tdg.linearize_plain(*_f64(args), hold)
    mb, me = rounding_scale(*args)
    line, rms = [], {}
    for name, (_, b, e) in (("kernel", tdg.linearize(*args, hold)),
                            ("plain", tdg.linearize_plain(*args, hold))):
        rb = (b.double() - ref[1]).abs() / (EPS32 * mb)
        rb = rb.nan_to_num(0)  # rows with no term: both 0
        re_ = abs(float(e) - float(ref[2])) / (EPS32 * float(me))
        assert float(rb.max()) <= ROUNDINGS and re_ <= ROUNDINGS, (name, float(rb.max()), re_)
        rms[name] = float(rb.square().mean().sqrt())
        line.append(f"{name} b max {float(rb.max()):.3f} rms {rms[name]:.4f}, err {re_:.4f}")
    assert rms["kernel"] <= rms["plain"], line
    b_rel = (ref[1] - tdg.linearize_plain(*args, hold)[1].double()).norm() / ref[1].norm()
    print(f"[fg-linearize] f64 {window} {case}, in eps32 m: {'; '.join(line)}; b from f64 "
          f"(plain, by norm) {float(b_rel):.2e}")


@pytest.mark.cuda
@pytest.mark.parametrize("window", ["nw8", "nw20_gnss"])
def test_two_launches_give_the_same_bits(dev, window):
    args = _inputs(window, dev)
    a, b = tdg.linearize(*args), tdg.linearize(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_the_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    st, pg, vH, vv, lR, lt, mgd = _inputs("nw8", dev)
    with pytest.raises(ValueError, match="vis_H"):
        tdg.linearize(st, pg, vH.double(), vv, lR, lt, mgd)
    with pytest.raises(ValueError, match="mgd_H"):
        tdg.linearize(st, pg, vH, vv, lR, lt, mgd._replace(H=mgd.H.cpu()))


def _counts():
    m = profiling.TRACER.mark()
    return m["lm_launched"], m["lm_replayed"], m["lm_kernel_linearized"]


def _solve(args):
    c0 = _counts()
    st, (err, its) = tdg.lm_optimize(*args, poll=FlagPoll(blocking=True))
    return st, err, int(its), tuple(a - b for a, b in zip(_counts(), c0))


@pytest.mark.cuda
@pytest.mark.parametrize("window", ["nw8", "nw20_gnss", "nw64_gnss"])
def test_replayed_pass_with_the_kernel_matches_the_eager_plain_pass(dev, window, monkeypatch):
    args = _inputs(window, dev)
    st, err, its, (launched, replayed, kernel) = _solve(args)
    with monkeypatch.context() as m:
        m.setattr(tdg, "_lm_pass", tdg._EagerLM)
        m.setattr(tdg, "linearize", tdg.linearize_plain)
        st_p, err_p, its_p, (launched_p, replayed_p, kernel_p) = _solve(args)
    assert launched == replayed == kernel == its and (replayed_p, kernel_p) == (0, 0)
    assert abs(its - its_p) <= 1 and its > 1
    worst = 0.0
    for a, b in zip(st[:4], st_p[:4]):
        worst = max(worst, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
    e_rel = abs(float(err) - float(err_p)) / abs(float(err_p))
    assert worst <= 1e-4 and e_rel <= 1e-3
    print(f"[fg-linearize] LM {window}: iterations {its} (eager plain {its_p}), state within "
          f"{worst:.2e} of each field's scale, error {float(err):.6e} against "
          f"{float(err_p):.6e}")


@pytest.mark.cuda
@pytest.mark.parametrize("window", ["nw8", "nw20_gnss"])
def test_capture_and_replays_make_no_synchronising_call(dev, window):
    args = _inputs(window, dev)
    tdg._REPLAYED.clear()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, (_, its) = tdg.lm_optimize(*args, poll=FlagPoll())  # captures, then replays
        st2, (_, its2) = tdg.lm_optimize(*args, poll=FlagPoll())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    (lm,) = tdg._REPLAYED.values()
    assert lm.kernel and int(its) == int(its2) > 1
    for a, b in zip(st[:4], st2[:4]):
        assert torch.equal(a, b)


def _card_ms(fn, n=50):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def _graph_of(fn):
    """``fn`` captured as _ReplayedLM captures (a warm-up on a side stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        g = tdg._ReplayedLM._capture(fn)
    torch.cuda.current_stream().wait_stream(side)
    return g


@pytest.mark.cuda
def test_card_times_at_the_cells_window(dev, monkeypatch):
    """``linearize`` and one replayed LM iteration at NW = 20, in card ms
    (CUDA events over 50 replays): the kernel against the plain version,
    each as a CUDA graph replay (how the LM runs it), and the kernel's eager
    launches, which the host's wrapper paces."""
    args = _inputs("nw20_gnss", dev)
    ts = tdg._lm_tensors(*args)
    kernel_ms = _card_ms(_graph_of(lambda: tdg.linearize(*args)).replay)
    eager_ms = _card_ms(lambda: tdg.linearize(*args))
    plain_ms = _card_ms(_graph_of(lambda: tdg.linearize_plain(*args)).replay)
    it_kernel = tdg._ReplayedLM(ts, 1e-5, STEP)
    it_kernel.load(ts)
    with monkeypatch.context() as m:
        m.setattr(tdg, "linearize", tdg.linearize_plain)
        it_plain = tdg._ReplayedLM(ts, 1e-5, STEP)
    it_plain.load(ts)
    assert it_kernel.kernel and not it_plain.kernel
    iter_kernel_ms, iter_plain_ms = _card_ms(it_kernel.iterate), _card_ms(it_plain.iterate)
    t0 = time.perf_counter()
    for _ in range(50):
        tdg.linearize(*args)
    host_us = (time.perf_counter() - t0) * 1e6 / 50
    torch.cuda.synchronize()
    print(f"[fg-linearize] NW=20, card ms: linearize kernel {kernel_ms:.4f} (a graph replay; "
          f"{eager_ms:.4f} launched eagerly, {host_us:.1f} us of host each), plain version "
          f"{plain_ms:.4f} (a graph replay); one "
          f"replayed LM iteration with the kernel {iter_kernel_ms:.4f}, with the plain version "
          f"{iter_plain_ms:.4f}; {torch.cuda.get_device_name(0)}")
    assert kernel_ms < plain_ms and iter_kernel_ms < iter_plain_ms
