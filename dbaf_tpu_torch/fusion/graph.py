"""Nonlinear factor graph, Levenberg-Marquardt, and marginalization.

The solver core replacing the reference's GTSAM usage
(reference dbaf/depth_video.py:480-558): dense normal-equation
assembly over the (tiny, <=25-state) window, damped LM on the
SE(3) x R^3 x R^6 product manifold, ``linearizeToHessianFactor`` and
``marginalizeOut`` (Schur elimination of dropped states into a
LinearContainerFactor prior -- the O(1)-memory long-context mechanism,
SURVEY.md 5.7).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .factors import Factor, LinearContainerFactor
from .se3np import Pose


def _vdim(x) -> int:
    return 6 if isinstance(x, Pose) else len(x)


def _retract(x, d):
    if isinstance(x, Pose):
        return x.retract(d)
    return x + d


class Values(dict):
    """key -> Pose | np.ndarray."""

    def retract_all(self, delta: Dict[str, np.ndarray]) -> "Values":
        out = Values(self)
        for k, d in delta.items():
            out[k] = _retract(out[k], d)
        return out

    def copy(self) -> "Values":
        return Values(self)


class FactorGraph:
    def __init__(self, factors: Optional[Iterable[Factor]] = None):
        self.factors: List[Factor] = list(factors) if factors else []

    def add(self, f: Factor):
        self.factors.append(f)

    def push_back(self, f: Factor):
        self.factors.append(f)

    def __len__(self):
        return len(self.factors)

    # ------------------------------------------------------------------
    def _ordering(self, values: Values) -> Tuple[List[str], Dict[str, slice]]:
        keys = sorted(
            {k for f in self.factors for k in f.keys},
            key=lambda s: (s[0], int(s[1:])),
        )
        slices = {}
        off = 0
        for k in keys:
            d = _vdim(values[k])
            slices[k] = slice(off, off + d)
            off += d
        return keys, slices

    def linearize(self, values: Values):
        """Dense normal equations: returns (keys, slices, H, b, error)
        solving H d = b for the GN step."""
        keys, slices = self._ordering(values)
        n = max((s.stop for s in slices.values()), default=0)
        H = np.zeros((n, n))
        b = np.zeros(n)
        total_err = 0.0

        for f in self.factors:
            if isinstance(f, LinearContainerFactor):
                Hf, bf, err = f.quadratic(values)
                sls = [slices[k] for k in f.keys]
                offs = np.cumsum([0] + [sl.stop - sl.start for sl in sls])
                for a, sa in enumerate(sls):
                    b[sa] += bf[offs[a] : offs[a + 1]]
                    for c, sc in enumerate(sls):
                        H[sa, sc] += Hf[
                            offs[a] : offs[a + 1], offs[c] : offs[c + 1]
                        ]
                total_err += err
                continue

            _, J, Lam, r, err = f.linearize(values)
            total_err += err
            items = list(J.items())
            for ka, Ja in items:
                sa = slices[ka]
                JtL = Ja.T @ Lam
                b[sa] += -JtL @ r
                for kc, Jc in items:
                    H[sa, slices[kc]] += JtL @ Jc
        return keys, slices, H, b, total_err

    def error(self, values: Values) -> float:
        total = 0.0
        for f in self.factors:
            if isinstance(f, LinearContainerFactor):
                total += f.quadratic(values)[2]
            else:
                r, _ = f.error_and_jacobians(values)
                _, err = f.noise.weighted(r)
                total += err
        return total

    def linearize_to_hessian(self, values: Values):
        """gtsam ``linearizeToHessianFactor`` equivalent
        (depth_video.py:303): returns a LinearContainerFactor capturing the
        full graph's Gaussian at ``values``."""
        keys, slices, H, b, _ = self.linearize(values)
        dims = [slices[k].stop - slices[k].start for k in keys]
        lin_point = {k: values[k] for k in keys}
        return LinearContainerFactor(keys, dims, H, b, lin_point)


def marginalize_out(
    graph: FactorGraph, values: Values, remove_keys: Sequence[str]
) -> LinearContainerFactor:
    """Schur-eliminate ``remove_keys`` from the graph linearized at
    ``values`` (gtsam fork ``marginalizeOut``, depth_video.py:443)."""
    keys, slices, H, b, _ = graph.linearize(values)
    rm = [k for k in keys if k in set(remove_keys)]
    keep = [k for k in keys if k not in set(remove_keys)]
    ridx = np.concatenate([np.arange(slices[k].start, slices[k].stop) for k in rm]) if rm else np.zeros(0, int)
    kidx = np.concatenate([np.arange(slices[k].start, slices[k].stop) for k in keep]) if keep else np.zeros(0, int)

    Hkk = H[np.ix_(kidx, kidx)]
    Hkr = H[np.ix_(kidx, ridx)]
    Hrr = H[np.ix_(ridx, ridx)]
    bk = b[kidx]
    br = b[ridx]

    # regularized elimination (Hrr may be rank-deficient for unconstrained
    # directions; matches the reference's small-diagonal stabilization)
    Hrr_inv = np.linalg.inv(Hrr + np.eye(len(ridx)) * 1e-10)
    Hm = Hkk - Hkr @ Hrr_inv @ Hkr.T
    bm = bk - Hkr @ Hrr_inv @ br

    dims = [slices[k].stop - slices[k].start for k in keep]
    lin_point = {k: values[k] for k in keep}
    return LinearContainerFactor(keep, dims, Hm, bm, lin_point)


class LevenbergMarquardt:
    """Damped GN matching gtsam.LevenbergMarquardtOptimizer defaults
    (lambdaInitial 1e-5, lambdaFactor 10)."""

    def __init__(
        self,
        graph: FactorGraph,
        initial: Values,
        lambda_initial: float = 1e-5,
        lambda_factor: float = 10.0,
        max_iterations: int = 100,
        relative_tol: float = 1e-5,
        absolute_tol: float = 1e-5,
        lambda_max: float = 1e5,
    ):
        self.graph = graph
        self.values = initial.copy()
        self.lam = lambda_initial
        self.lam_factor = lambda_factor
        self.max_iterations = max_iterations
        self.relative_tol = relative_tol
        self.absolute_tol = absolute_tol
        self.lambda_max = lambda_max

    def optimize(self) -> Values:
        err = self.graph.error(self.values)
        for _ in range(self.max_iterations):
            keys, slices, H, b, _ = self.graph.linearize(self.values)
            if not keys:
                break
            improved = False
            while self.lam <= self.lambda_max:
                Hd = H + self.lam * np.diag(np.diag(H)) + 1e-12 * np.eye(len(b))
                try:
                    d = np.linalg.solve(Hd, b)
                except np.linalg.LinAlgError:
                    self.lam *= self.lam_factor
                    continue
                delta = {k: d[slices[k]] for k in keys}
                new_values = self.values.retract_all(delta)
                new_err = self.graph.error(new_values)
                if new_err < err:
                    improved = True
                    rel = abs(err - new_err) / max(abs(err), 1e-12)
                    self.values = new_values
                    self.lam = max(self.lam / self.lam_factor, 1e-10)
                    converged = (
                        rel < self.relative_tol
                        or abs(err - new_err) < self.absolute_tol
                    )
                    err = new_err
                    if converged:
                        return self.values
                    break
                self.lam *= self.lam_factor
            if not improved:
                break
        return self.values
