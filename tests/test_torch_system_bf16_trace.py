"""The port's DBAFusion end to end on the CPU in bf16: the 16-frame golden
trace of ``test_golden_trace.py`` (same config, weights and frames, helpers
in ``test_torch_system.py``), held against ``tests/data/golden_trace.npz``.

Bounds.  ``test_golden_trace.py:129-143`` holds the JAX package to its own
recorded trace: fmap0_slice atol 1e-4, fmap0_absmean rtol 1e-4, traj /
disp_mean / disp_std atol 5e-3.  Those bounds need bit-equal bf16 rounding,
and a bf16 network cannot give that across frameworks: every convolution,
norm and activation rounds to bf16, and a sum taken in another order flips
a rounding now and then; the flips compound through the encoder's layers
and the random-weight BA chain.  The JAX package shows the same thing on
its own: rerun with XLA's excess bf16 precision turned off
(``XLA_FLAGS=--xla_allow_excess_precision=false``, a pure change of rounding
points), it misses its recorded trace by fmap0_slice 0.043, fmap0_absmean
3.0e-4 (relative), traj 7.8e-3, disp_mean 0.165 and disp_std 0.139.  The
port's bf16 trace misses it by 0.067, 2.2e-4, 7.5e-3 to 7.8e-3, 0.23 to 0.27
and 0.15 to 0.27 (torch on 1, 3 and 8 CPU threads: the thread count changes
the order of the CPU sums too).

So the bf16 trace is held to bounds that cover that spread about twice
(traj atol 2e-2; disp_mean / disp_std atol 0.6, against values up to 18;
fmap0_slice 16 bf16 ulps of its largest entry; fmap0_absmean rtol 1e-3).
The f32 network's trace is held against the JAX DBAFusion in
``test_torch_system_f32_trace.py``.
"""

import os

import numpy as np
import torch

from tests.test_golden_trace import DATA
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_system import _port, _summary, params  # noqa: F401  (fixture)


def test_bf16_trace_against_golden(params):
    got = _summary(_port(params, torch.bfloat16))
    ref = np.load(os.path.join(DATA, "golden_trace.npz"))
    assert got["traj"].shape == ref["traj"].shape
    assert np.all(np.isfinite(got["traj"]))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref["fmap0_slice"]).max())) - 7)
    np.testing.assert_allclose(got["fmap0_slice"], ref["fmap0_slice"], atol=16 * ulp)
    np.testing.assert_allclose(got["fmap0_absmean"], ref["fmap0_absmean"], rtol=1e-3)
    np.testing.assert_allclose(got["traj"], ref["traj"], atol=2e-2)
    np.testing.assert_allclose(got["disp_mean"], ref["disp_mean"], atol=0.6)
    np.testing.assert_allclose(got["disp_std"], ref["disp_std"], atol=0.6)
