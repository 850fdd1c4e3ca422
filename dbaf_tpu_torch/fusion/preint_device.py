"""Device-side IMU preintegration chunks: compose, correct, predict (f32).

Port of ``dbaf_tpu/fusion/preint_device.py``.  The asynchronous coupled
pipeline (``slam/coupled_async.py``) learns of a keyframe cull one step after
the host packed the factor graph, so the device repairs that pack itself:
the culled keyframe's two IMU intervals are joined by composing their
preintegrated summaries, which is exact for the discrete model of
``fusion/preintegration.py::integrate`` (the per-step error-state transition
matrices multiply into a macro-step transition whose blocks are the deltas
and Jacobians each chunk already stores).  Mixed bias linearization points
are handled by a first-order re-correction of the right chunk, as the
CombinedImuFactor treats biases.

Every function takes tensors on any device and makes no host read.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .device_graph import _hat, _mv, _orthonormalize, _so3_exp


class Chunk(NamedTuple):
    """Preintegrated IMU summary over one interval: deltas, bias Jacobians,
    covariance and the bias linearization point (fusion/preintegration.py
    ``PreintegratedImu``)."""
    dR: torch.Tensor     # (3, 3)
    dv: torch.Tensor     # (3,)
    dp: torch.Tensor     # (3,)
    dt: torch.Tensor     # ()
    dRg: torch.Tensor    # (3, 3) dLog(dR)/dbg
    dvg: torch.Tensor    # (3, 3)
    dva: torch.Tensor    # (3, 3)
    dpg: torch.Tensor    # (3, 3)
    dpa: torch.Tensor    # (3, 3)
    bias0: torch.Tensor  # (6,) [ba, bg] linearization point
    cov: torch.Tensor    # (15, 15) over [theta, v, p, ba, bg]


CHUNK_FLAT = 9 * 6 + 3 + 3 + 1 + 6 + 225  # = 292


def identity_chunk(bias0: Optional[torch.Tensor] = None, dtype=torch.float32,
                   device=None) -> Chunk:
    """Zero-length interval (the state of a fresh PreintegratedImu)."""
    kw = dict(dtype=dtype, device=device)
    z3 = torch.zeros((3, 3), **kw)
    b = torch.zeros(6, **kw) if bias0 is None else torch.as_tensor(bias0, **kw)
    return Chunk(torch.eye(3, **kw), torch.zeros(3, **kw), torch.zeros(3, **kw),
                 torch.zeros((), **kw), z3, z3, z3, z3, z3, b, torch.zeros((15, 15), **kw))


def pack_chunk_np(pim) -> np.ndarray:
    """Host PreintegratedImu -> flat f32 row of CHUNK_FLAT values."""
    f = lambda a: np.asarray(a, np.float32).reshape(-1)  # noqa: E731
    return np.concatenate([
        f(pim.dR), f(pim.dv), f(pim.dp), f([pim.dt]), f(pim.dRg), f(pim.dvg), f(pim.dva),
        f(pim.dpg), f(pim.dpa), f(pim.bias), f(pim.cov),
    ])


def unpack_chunk(row: torch.Tensor) -> Chunk:
    """Flat (292,) row -> Chunk (views)."""
    m = lambda a, b: row[a:b].reshape(3, 3)  # noqa: E731
    return Chunk(dR=m(0, 9), dv=row[9:12], dp=row[12:15], dt=row[15], dRg=m(16, 25),
                 dvg=m(25, 34), dva=m(34, 43), dpg=m(43, 52), dpa=m(52, 61), bias0=row[61:67],
                 cov=row[67:292].reshape(15, 15))


def flatten_chunk(c: Chunk) -> torch.Tensor:
    """Chunk -> flat (..., 292) rows (inverse of unpack_chunk); a leading
    batch dimension on every field is kept."""
    lead = c.dv.shape[:-1]
    f = lambda a: a.reshape(lead + (-1,))  # noqa: E731
    return torch.cat([f(c.dR), c.dv, c.dp, c.dt[..., None], f(c.dRg), f(c.dvg), f(c.dva),
                      f(c.dpg), f(c.dpa), c.bias0, f(c.cov)], dim=-1)


def corrected_deltas(c: Chunk, bias: torch.Tensor):
    """First-order bias-corrected deltas at a new bias estimate
    (preintegration.py:136-143)."""
    db_a = bias[:3] - c.bias0[:3]
    db_g = bias[3:] - c.bias0[3:]
    dR = c.dR @ _so3_exp(_mv(c.dRg, db_g))
    dv = c.dv + _mv(c.dva, db_a) + _mv(c.dvg, db_g)
    dp = c.dp + _mv(c.dpa, db_a) + _mv(c.dpg, db_g)
    return dR, dv, dp


def rebias(c: Chunk, bias0: torch.Tensor) -> Chunk:
    """Move the linearization point (first order: Jacobians and covariance
    are derivatives, unchanged to this order)."""
    dR, dv, dp = corrected_deltas(c, bias0)
    return c._replace(dR=_orthonormalize(dR), dv=dv, dp=dp, bias0=bias0.to(c.dv.dtype))


def compose(A: Chunk, B: Chunk) -> Chunk:
    """Preintegration over [a,b] ++ [b,c] -> [a,c], at A's linearization
    point.  Exact (per-step transition product) when the bias0 match;
    first order in |bias0_A - bias0_B| otherwise.

    With the right-perturbation error convention of preintegration.py
    (dR_true = dR Exp(theta)) the composed errors are
        theta_AB = dR_B^T theta_A + dRg_B dbg_A + theta_B
        dv_AB    = dv_A - dR_A [dv_B]x theta_A
                   + dR_A (dva_B dba_A + dvg_B dbg_A) + dR_A dv_B
        dp_AB    = dp_A + dv_A dt_B - dR_A [dp_B]x theta_A
                   + dR_A (dpa_B dba_A + dpg_B dbg_A) + dR_A dp_B
    so Sigma_AB = F Sigma_A F^T + D Sigma_B D^T with
    D = blkdiag(I3, dR_A, dR_A, I6).
    """
    dtype, dev = A.dv.dtype, A.dv.device
    Bc = rebias(B, A.bias0)

    dR = A.dR @ Bc.dR
    dv = A.dv + _mv(A.dR, Bc.dv)
    dp = A.dp + A.dv * Bc.dt + _mv(A.dR, Bc.dp)
    dt = A.dt + Bc.dt

    # bias-correction Jacobians of the composed deltas (Forster eq. 44
    # telescoped over a macro step)
    dRg = Bc.dR.T @ A.dRg + Bc.dRg
    dva = A.dva + A.dR @ Bc.dva
    dvg = A.dvg + A.dR @ Bc.dvg - A.dR @ _hat(Bc.dv) @ A.dRg
    dpa = A.dpa + A.dva * Bc.dt + A.dR @ Bc.dpa
    dpg = A.dpg + A.dvg * Bc.dt + A.dR @ Bc.dpg - A.dR @ _hat(Bc.dp) @ A.dRg

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    z3 = torch.zeros((3, 3), dtype=dtype, device=dev)
    z36 = torch.zeros((3, 6), dtype=dtype, device=dev)
    F = torch.cat([
        torch.cat([Bc.dR.T, z3, z3, z3, Bc.dRg], 1),
        torch.cat([-A.dR @ _hat(Bc.dv), eye3, z3, A.dR @ Bc.dva, A.dR @ Bc.dvg], 1),
        torch.cat([-A.dR @ _hat(Bc.dp), eye3 * Bc.dt, eye3, A.dR @ Bc.dpa, A.dR @ Bc.dpg], 1),
        torch.cat([torch.zeros((6, 9), dtype=dtype, device=dev),
                   torch.eye(6, dtype=dtype, device=dev)], 1),
    ], 0)
    D = torch.cat([
        torch.cat([eye3, z3, z3, z36], 1),
        torch.cat([z3, A.dR, z3, z36], 1),
        torch.cat([z3, z3, A.dR, z36], 1),
        torch.cat([torch.zeros((6, 9), dtype=dtype, device=dev),
                   torch.eye(6, dtype=dtype, device=dev)], 1),
    ], 0)
    cov = F @ A.cov @ F.T + D @ Bc.cov @ D.T
    return Chunk(_orthonormalize(dR), dv, dp, dt, dRg, dvg, dva, dpg, dpa, A.bias0, cov)


def predict(c: Chunk, R, t, vel, bias, g_vec):
    """NavState propagation under gravity (preintegration.py:145-153): the
    IMU-predicted seed of a newly admitted keyframe."""
    dR, dv, dp = corrected_deltas(c, bias)
    Rj = _orthonormalize(R @ dR)
    tj = t + vel * c.dt + 0.5 * g_vec * c.dt * c.dt + _mv(R, dp)
    vj = vel + g_vec * c.dt + _mv(R, dv)
    return Rj, tj, vj


def noise_information(cov: torch.Tensor) -> torch.Tensor:
    """Jacobi-scaled 15x15 inverse: the information matrix the factor
    linearization consumes (preintegration.py:165-169).  The covariance
    spans ~8 decades across [theta, v, p, ba, bg], so the f32 inversion runs
    at O(1) scales.  ``inv_ex`` reports a singular matrix on the device
    instead of raising on the host."""
    cov = cov + torch.eye(15, dtype=cov.dtype, device=cov.device) * 1e-12  # the host's ridge
    d = torch.sqrt(torch.abs(torch.diagonal(cov)))
    live = d > 1e-30
    dinv = torch.where(live, 1.0 / torch.where(live, d, torch.ones_like(d)), torch.ones_like(d))
    Cn = cov * dinv[:, None] * dinv[None, :]
    In = torch.linalg.inv_ex(Cn)[0]
    return In * dinv[:, None] * dinv[None, :]
