"""The rounding model that the hand kernel's card test holds b and err to
(``tests/lm_windows.py::rounding_scale``), checked on the CPU where the
plain version (``fusion/device_graph.py::linearize_plain``) runs: in f32 it
lies within 8 eps32 m of its own f64 evaluation on the same f32 inputs, per
entry of b and for err, on the card test's windows, the settled ones
included (``settled_inputs``: the cells' regime, where every term's
gradient cancels to a small b and f32 leaves b some 1e-3 off by norm).
``tests/test_torch_linearize_cuda.py`` holds the kernel to the same bound."""

import pytest
import torch

from dbaf_tpu_torch.fusion import device_graph as tdg
from tests.lm_windows import (EPS32, ROUNDINGS, _f64, cut_masks, lm_inputs, rounding_scale,
                              settled_inputs)
WINDOWS = {"nw8": dict(nw=8, n=5, seed=7), "nw20_gnss": dict(nw=20, n=14, seed=3, gnss=True),
           "nw8_settled": dict(nw=8, n=5, seed=7, settled=True),
           "nw20_gnss_settled": dict(nw=20, n=14, seed=3, gnss=True, settled=True)}
_INPUTS = {}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(window):
    if window not in _INPUTS:
        kw = dict(WINDOWS[window])
        _INPUTS[window] = (settled_inputs if kw.pop("settled", False) else lm_inputs)(**kw)
    return _INPUTS[window]


def _args(window, case):
    st, pg, vH, vv, lR, lt, mgd = _inputs(window)
    if case == "marginalization":  # marginalize_window_body's call
        return (st, cut_masks(pg, 2), vH, vv, st.R, st.t, mgd), False
    return (st, pg, vH, vv, lR, lt, mgd), True


@pytest.mark.parametrize("case", ["full", "marginalization"])
@pytest.mark.parametrize("window", WINDOWS)
def test_the_plain_version_lies_within_its_rounding_bound(window, case):
    args, hold = _args(window, case)
    _, b, e = tdg.linearize_plain(*args, hold)
    _, b64, e64 = tdg.linearize_plain(*_f64(args), hold)
    mb, me = rounding_scale(*args)
    diff = (b.double() - b64).abs()
    assert torch.all(diff[mb == 0] == 0)
    assert float((diff / (EPS32 * mb)).nan_to_num(0).max()) <= ROUNDINGS
    assert abs(float(e) - float(e64)) <= ROUNDINGS * EPS32 * float(me)


@pytest.mark.parametrize("window", ["nw8", "nw20_gnss"])
def test_the_settled_windows_reach_the_cells_cancellation(window):
    """The settled window's b is small against its terms, so that f32 leaves
    it at least 1e-3 off by norm, where the unsettled window's is within
    1e-6; its state has moved off the visual system's linearization points,
    and off the marginal's so far that H @ dvec is of the size of v and
    cancels part of it."""
    rel = {}
    for name in (window, window + "_settled"):
        args, _ = _args(name, "full")
        _, b, _ = tdg.linearize_plain(*args)
        _, b64, _ = tdg.linearize_plain(*_f64(args))
        rel[name] = float((b.double() - b64).norm() / b64.norm())
    assert rel[window] < 1e-6 < 1e-3 < rel[window + "_settled"]
    st, _, _, _, lR, lt, mgd = _inputs(window + "_settled")
    n = int(st.valid.sum())
    assert float((st.t[:n] - lt[:n]).abs().max()) > 1e-3
    st, mgd = _f64(st), _f64(mgd)
    NW = st.R.shape[0]
    lin = mgd.lin
    dvec = torch.cat([tdg._se3_local(lin[:, :9].reshape(NW, 3, 3), lin[:, 9:12], st.R, st.t),
                      st.vel - lin[:, 12:15], st.bias - lin[:, 15:21]], -1)
    Hd = mgd.H @ (dvec * mgd.mask[:, None].double()).reshape(-1)
    assert 0.5 * mgd.v.norm() < Hd.norm() and (mgd.v - Hd).norm() < mgd.v.norm()
