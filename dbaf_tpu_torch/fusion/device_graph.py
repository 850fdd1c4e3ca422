"""Device factor-graph solve for the tightly-coupled DBA loop (f32).

Port of ``dbaf_tpu/fusion/device_graph.py``.  The window graph packs into
fixed-shape tensors (per-frame 15-dim tangent layout [pose w, v | vel |
bias]) and the whole Levenberg-Marquardt solve -- factor linearization,
damped Cholesky solve, manifold retraction -- runs on the device next to the
visual reduced camera system, so a coupled round moves no window state to
the host.

Factor coverage (the live set of depth_video.py:480-521): CombinedImuFactor,
PriorPose, PriorVec (bias), GPSFactor (Cauchy robust, lever arm applied on
the host), VelFactor, the marginal LinearContainerFactor and the visual
CustomHessianFactor (camera->body adjoint on the device).

Eager-PyTorch notes:

* the vmapped per-factor closures of the JAX package are batched tensor
  formulas; masks stay multiplications, as there;
* every block scatter-add (``H.at[rows, cols].add``) is an ``index_put_``
  with ``accumulate=True``, which sums repeated indices;
* the LM ``while_loop`` is a Python loop that reads its ``done`` flag on the
  host once per iteration and stops there, so the state is frozen once done
  and the iteration count is the realized one.  On the card an iteration
  is one replay of a captured CUDA graph (tens of microseconds of host
  against hundreds of small launches), so where the flag is read without
  waiting (the asynchronous pipeline) the loop bounds its run-ahead: before
  launching iteration k + 1 it waits for iteration k - 1's flag, unless a
  later one has answered.  The card then always has one iteration queued,
  and a pass launches at most one iteration past its realized count;
* a failed Cholesky factorization: ``cholesky_ex`` returns a partial factor
  and ``info > 0`` where ``cho_factor`` gives NaN, so the step is accepted
  only with ``info == 0`` as well as a finite step;
* on the card ``linearize`` is one hand-written kernel
  (``csrc/fg_linearize.cu``, a block per 15-row frame band, no atomics)
  where XLA fuses the JAX package's; the CPU runs its plain version,
  ``linearize_plain``, the batched formulas above.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.device import FlagPoll
from ..utils.profiling import TRACER

# ---------------------------------------------------------------------------
# f32-safe SO(3)/SE(3) (matrix form, [omega, v] tangents, right perturbation)
# ---------------------------------------------------------------------------


def _eye3(x: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device)


def _hat(w: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zero, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], zero, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], zero], -1),
    ], -2)


def _theta(w: torch.Tensor):
    th2 = torch.sum(w * w, -1)
    return th2, torch.sqrt(th2 + 1e-30)


def _so3_exp(w: torch.Tensor) -> torch.Tensor:
    th2, th = _theta(w)
    small = th < 1e-4
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2)
    W = _hat(w)
    return _eye3(w) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def _so3_log(R: torch.Tensor) -> torch.Tensor:
    tr = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) / 2.0, -1.0, 1.0)
    th = torch.arccos(tr)
    skew = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], -1)
    small = th < 1e-4
    # residual rotations in the coupled window stay far from pi
    scale = torch.where(small, 0.5 + th * th / 12.0,
                        0.5 * th / torch.sin(torch.where(small, torch.ones_like(th), th)))
    return scale[..., None] * skew


def _so3_V(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3) (the V of SE(3) exp)."""
    th2, th = _theta(w)
    small = th < 1e-4
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2)
    C = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (th - torch.sin(th)) / (th2 * th))
    W = _hat(w)
    return _eye3(w) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def _cot_term(w: torch.Tensor) -> torch.Tensor:
    th2, th = _theta(w)
    small = th < 1e-4
    one = torch.ones_like(th)
    return torch.where(
        small, 1.0 / 12.0 + th2 / 720.0,
        (1.0 / torch.where(small, one, th2))
        - (1.0 + torch.cos(th)) / (2.0 * th * torch.sin(torch.where(small, one, th))))


def _so3_V_inv(w: torch.Tensor) -> torch.Tensor:
    W = _hat(w)
    return _eye3(w) - 0.5 * W + _cot_term(w)[..., None, None] * (W @ W)


def _jr_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SO(3)."""
    W = _hat(w)
    return _eye3(w) + 0.5 * W + _cot_term(w)[..., None, None] * (W @ W)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _se3_retract(R, t, xi):
    """T * Exp(xi), xi = [omega, v] (se3np.Pose.retract)."""
    w, v = xi[..., :3], xi[..., 3:]
    return R @ _so3_exp(w), t + _mv(R, _mv(_so3_V(w), v))


def _se3_local(Ra, ta, Rb, tb):
    """Log(Ta^-1 Tb) -> [omega, v]."""
    RaT = Ra.transpose(-1, -2)
    w = _so3_log(RaT @ Rb)
    return torch.cat([w, _mv(_so3_V_inv(w), _mv(RaT, tb - ta))], -1)


def _orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Project back to SO(3) (f32 drift control): Gram-Schmidt columns."""
    c0 = R[..., :, 0]
    c0 = c0 / torch.linalg.norm(c0, dim=-1, keepdim=True)
    c1 = R[..., :, 1]
    c1 = c1 - torch.sum(c0 * c1, -1, keepdim=True) * c0
    c1 = c1 / torch.linalg.norm(c1, dim=-1, keepdim=True)
    c2 = torch.linalg.cross(c0, c1, dim=-1)
    return torch.stack([c0, c1, c2], -1)


# ---------------------------------------------------------------------------
# packed graph + state
# ---------------------------------------------------------------------------


class FgState(NamedTuple):
    """Window states, slot f = global frame t0+f."""
    R: torch.Tensor      # (NW, 3, 3) body rotation wRb
    t: torch.Tensor      # (NW, 3)
    vel: torch.Tensor    # (NW, 3)
    bias: torch.Tensor   # (NW, 6) [ba, bg]
    valid: torch.Tensor  # (NW,) bool


class PackedGraph(NamedTuple):
    """Fixed-capacity tensors for every non-visual factor."""
    # IMU factors: slot k connects frames (k, k+1)
    imu_mask: torch.Tensor   # (NW-1,)
    imu_dR: torch.Tensor     # (NW-1, 3, 3)
    imu_dv: torch.Tensor     # (NW-1, 3)
    imu_dp: torch.Tensor     # (NW-1, 3)
    imu_dt: torch.Tensor     # (NW-1,)
    imu_dRg: torch.Tensor    # (NW-1, 3, 3)
    imu_dvg: torch.Tensor
    imu_dva: torch.Tensor
    imu_dpg: torch.Tensor
    imu_dpa: torch.Tensor
    imu_bias0: torch.Tensor  # (NW-1, 6) integration bias
    imu_info: torch.Tensor   # (NW-1, 15, 15)
    g_vec: torch.Tensor      # (3,)
    # pose priors
    pp_mask: torch.Tensor    # (PP,)
    pp_frame: torch.Tensor   # (PP,)
    pp_R: torch.Tensor       # (PP, 3, 3)
    pp_t: torch.Tensor       # (PP, 3)
    pp_info: torch.Tensor    # (PP, 6, 6)
    # bias priors (PriorVec on B)
    pb_mask: torch.Tensor    # (PB,)
    pb_frame: torch.Tensor
    pb_prior: torch.Tensor   # (PB, 6)
    pb_info: torch.Tensor    # (PB, 6, 6)
    # GNSS per frame (lever arm applied on the host, Cauchy robust)
    gnss_mask: torch.Tensor  # (NW,)
    gnss_pos: torch.Tensor   # (NW, 3)
    gnss_info: torch.Tensor  # (3, 3)
    gnss_k2: torch.Tensor    # () Cauchy k^2
    # wheel-odometry body velocity per frame
    odo_mask: torch.Tensor   # (NW,)
    odo_vel: torch.Tensor    # (NW, 3)
    odo_info: torch.Tensor   # (3, 3)


class MargDense(NamedTuple):
    """Marginal prior (LinearContainerFactor) in dense window form: the
    quadratic 0.5|dx|^2_H - v.dx over the full (NW*15) window tangent at
    fixed lin points (rows/cols of absent dims are zero).  The device
    marginalization emits it directly, so it stays on the device across
    keyframes."""
    mask: torch.Tensor  # (NW,) frame participates
    lin: torch.Tensor   # (NW, 21) lin point rows [R(9)|t|vel|bias]
    H: torch.Tensor     # (NW*15, NW*15)
    v: torch.Tensor     # (NW*15,)


def marg_identity_np(NW: int) -> MargDense:
    """The empty marginal (no prior information), host arrays."""
    lin = np.zeros((NW, 21), np.float32)
    lin[:, :9] = np.eye(3, dtype=np.float32).reshape(9)
    N = NW * 15
    return MargDense(np.zeros(NW, bool), lin, np.zeros((N, N), np.float32),
                     np.zeros(N, np.float32))


def marg_to_device(md, device) -> MargDense:
    return MargDense(*(torch.as_tensor(np.asarray(a), device=device) for a in md))


def _graph_spec(NW: int, PP: int, PB: int):
    """(name, shape, kind) per PackedGraph field, in field order: the flat
    single-upload layout (kind 'f' f32, 'b' bool as 0/1, 'i' small int
    stored exactly in f32)."""
    NF = NW - 1
    by_name = dict(
        imu_mask=((NF,), "b"), imu_dR=((NF, 3, 3), "f"),
        imu_dv=((NF, 3), "f"), imu_dp=((NF, 3), "f"), imu_dt=((NF,), "f"),
        imu_dRg=((NF, 3, 3), "f"), imu_dvg=((NF, 3, 3), "f"),
        imu_dva=((NF, 3, 3), "f"), imu_dpg=((NF, 3, 3), "f"),
        imu_dpa=((NF, 3, 3), "f"), imu_bias0=((NF, 6), "f"),
        imu_info=((NF, 15, 15), "f"), g_vec=((3,), "f"),
        pp_mask=((PP,), "b"), pp_frame=((PP,), "i"),
        pp_R=((PP, 3, 3), "f"), pp_t=((PP, 3), "f"),
        pp_info=((PP, 6, 6), "f"),
        pb_mask=((PB,), "b"), pb_frame=((PB,), "i"),
        pb_prior=((PB, 6), "f"), pb_info=((PB, 6, 6), "f"),
        gnss_mask=((NW,), "b"), gnss_pos=((NW, 3), "f"),
        gnss_info=((3, 3), "f"), gnss_k2=((), "f"),
        odo_mask=((NW,), "b"), odo_vel=((NW, 3), "f"),
        odo_info=((3, 3), "f"),
    )
    return [(n, *by_name[n]) for n in PackedGraph._fields]


def flatten_graph_np(d: dict, NW: int, PP: int = 4, PB: int = 4) -> np.ndarray:
    """Host dict of numpy arrays -> one flat f32 buffer (single upload)."""
    parts = []
    for name, shape, _ in _graph_spec(NW, PP, PB):
        a = np.asarray(d[name], np.float32).reshape(-1)
        assert a.size == int(np.prod(shape, dtype=int)), name
        parts.append(a)
    return np.concatenate(parts)


def unflatten_graph(flat: torch.Tensor, NW: int, PP: int = 4, PB: int = 4) -> PackedGraph:
    """Flat device buffer -> PackedGraph (views and casts, no copy to host)."""
    out = {}
    o = 0
    for name, shape, kind in _graph_spec(NW, PP, PB):
        sz = int(np.prod(shape, dtype=int))
        a = flat[o: o + sz].reshape(shape)
        if kind == "b":
            a = a > 0.5
        elif kind == "i":
            a = a.to(torch.int64)
        out[name] = a
        o += sz
    return PackedGraph(**out)


def graph_flat_size(NW: int, PP: int = 4, PB: int = 4) -> int:
    return sum(int(np.prod(s, dtype=int)) for _, s, _ in _graph_spec(NW, PP, PB))


# per-frame 21-wide state row: [R.ravel(9) | t(3) | vel(3) | bias(6)]
def flatten_state_np(R, t, vel, bias) -> np.ndarray:
    NW = R.shape[0]
    return np.concatenate([R.reshape(NW, 9), t, vel, bias], axis=1).astype(np.float32).reshape(-1)


def flatten_state(fg: FgState) -> torch.Tensor:
    """FgState -> flat (NW*21,) f32 (one transfer on sync)."""
    NW = fg.R.shape[0]
    return torch.cat([fg.R.reshape(NW, 9), fg.t, fg.vel, fg.bias], dim=1).reshape(-1)


def unflatten_state(flat: torch.Tensor, n: int, NW: int) -> FgState:
    """Flat buffer + live count -> FgState (valid = arange < n)."""
    rows = flat.reshape(NW, 21)
    return FgState(rows[:, :9].reshape(NW, 3, 3), rows[:, 9:12], rows[:, 12:15],
                   rows[:, 15:21], torch.arange(NW, device=flat.device) < n)


# ---------------------------------------------------------------------------
# linearization
# ---------------------------------------------------------------------------


def _imu_residual_jac(state: FgState, pg: PackedGraph):
    """CombinedImuFactor residuals (K, 15) and stacked Jacobians (K, 15, 30)
    over [Xi(6) Vi(3) Bi(6) Xj(6) Vj(3) Bj(6)] for every slot k = (k, k+1)
    (fusion/factors.py:169-252)."""
    Ri, ti, vi, bi = state.R[:-1], state.t[:-1], state.vel[:-1], state.bias[:-1]
    Rj, tj, vj, bj = state.R[1:], state.t[1:], state.vel[1:], state.bias[1:]
    dt = pg.imu_dt[:, None]
    g = pg.g_vec
    db = bi - pg.imu_bias0
    dR = pg.imu_dR @ _so3_exp(_mv(pg.imu_dRg, db[:, 3:]))
    dv = pg.imu_dv + _mv(pg.imu_dva, db[:, :3]) + _mv(pg.imu_dvg, db[:, 3:])
    dp = pg.imu_dp + _mv(pg.imu_dpa, db[:, :3]) + _mv(pg.imu_dpg, db[:, 3:])

    RiT = Ri.transpose(-1, -2)
    Erot = dR.transpose(-1, -2) @ RiT @ Rj
    r_th = _so3_log(Erot)
    dvw = vj - vi - g * dt
    dpw = tj - ti - vi * dt - 0.5 * g * dt * dt
    r_v = _mv(RiT, dvw) - dv
    r_p = _mv(RiT, dpw) - dp
    r = torch.cat([r_th, r_v, r_p, bj - bi], -1)

    Jri = _jr_inv(r_th)
    K = Ri.shape[0]
    eye3 = _eye3(Ri)
    eye6 = torch.eye(6, dtype=Ri.dtype, device=Ri.device)
    J = torch.zeros((K, 15, 30), dtype=Ri.dtype, device=Ri.device)
    # Xi
    J[:, 0:3, 0:3] = -Jri @ Rj.transpose(-1, -2) @ Ri
    J[:, 3:6, 0:3] = _hat(_mv(RiT, dvw))
    J[:, 6:9, 0:3] = _hat(_mv(RiT, dpw))
    J[:, 6:9, 3:6] = -eye3
    # Vi
    J[:, 3:6, 6:9] = -RiT
    J[:, 6:9, 6:9] = -RiT * dt[:, :, None]
    # Bi
    J[:, 0:3, 12:15] = -Jri @ Erot.transpose(-1, -2) @ pg.imu_dRg
    J[:, 3:6, 9:12] = -pg.imu_dva
    J[:, 3:6, 12:15] = -pg.imu_dvg
    J[:, 6:9, 9:12] = -pg.imu_dpa
    J[:, 6:9, 12:15] = -pg.imu_dpg
    J[:, 9:15, 9:15] = -eye6
    # Xj
    J[:, 0:3, 15:18] = Jri
    J[:, 6:9, 18:21] = RiT @ Rj
    # Vj
    J[:, 3:6, 21:24] = RiT
    # Bj
    J[:, 9:15, 24:30] = eye6
    return r, J


def _prior_pose_jac(r: torch.Tensor) -> torch.Tensor:
    """d Log(M Exp(xi)) / d xi at xi=0 for SE(3): block inverse right
    Jacobian (the host uses finite differences; this analytic form matches
    to O(|r|^2))."""
    J = torch.zeros(r.shape[:-1] + (6, 6), dtype=r.dtype, device=r.device)
    J[..., :3, :3] = _jr_inv(r[..., :3])
    J[..., 3:, 3:] = _so3_V_inv(r[..., :3])
    return J


def _gauss_newton_terms(J, Lam, r, m):
    """Masked (J^T L J, -J^T L r, 0.5 r^T L r) per factor."""
    JtL = J.transpose(-1, -2) @ Lam
    m = m.to(J.dtype)
    return (m[:, None, None] * (JtL @ J), m[:, None] * -_mv(JtL, r),
            m * 0.5 * torch.sum(r * _mv(Lam, r), -1))


def _scatter_blocks(H, b, rows, A, rhs):
    """H[rows_i, rows_j] += A, b[rows] += rhs, summing repeated indices."""
    H.index_put_((rows[:, :, None], rows[:, None, :]), A, accumulate=True)
    b.index_put_((rows,), rhs, accumulate=True)


def linearize_plain(state: FgState, pg: PackedGraph, vis_H, vis_v, vis_linR, vis_lint,
                    mgd: Optional[MargDense] = None, hold_empty: bool = True):
    """Dense normal equations over the padded window (the plain version of
    :func:`linearize`).

    vis_H/vis_v: body-frame reduced camera system (NW*6 square/vec),
    anchored at vis_linR/vis_lint, placed at each frame's pose rows
    [15f, 15f + 6); mgd: dense marginal prior (or None).  Returns (H, b, err); with
    ``hold_empty`` unconstrained rows are held at identity (the solve needs
    an invertible system; the marginalization must not)."""
    NW = state.R.shape[0]
    N = NW * 15
    dtype, dev = state.t.dtype, state.t.device
    H = torch.zeros((N, N), dtype=dtype, device=dev)
    b = torch.zeros((N,), dtype=dtype, device=dev)
    ar = lambda n: torch.arange(n, device=dev)  # noqa: E731
    NWr = ar(NW)

    # IMU chain: contiguous 30x30 blocks at 15k
    r, J = _imu_residual_jac(state, pg)
    A, rhs, e = _gauss_newton_terms(J, pg.imu_info, r, pg.imu_mask)
    _scatter_blocks(H, b, (15 * ar(NW - 1))[:, None] + ar(30), A, rhs)
    err = torch.sum(e)

    # pose priors
    f = pg.pp_frame
    r = _se3_local(pg.pp_R, pg.pp_t, state.R[f], state.t[f])
    A, rhs, e = _gauss_newton_terms(_prior_pose_jac(r), pg.pp_info, r, pg.pp_mask)
    _scatter_blocks(H, b, (15 * f)[:, None] + ar(6), A, rhs)
    err = err + torch.sum(e)

    # bias priors
    f = pg.pb_frame
    r = state.bias[f] - pg.pb_prior
    m = pg.pb_mask.to(dtype)
    Lam = pg.pb_info
    _scatter_blocks(H, b, (15 * f + 9)[:, None] + ar(6), m[:, None, None] * Lam,
                    m[:, None] * -_mv(Lam, r))
    err = err + torch.sum(m * 0.5 * torch.sum(r * _mv(Lam, r), -1))

    # GNSS (Cauchy robust; J = [0 | R], factors.py:133-147)
    r = state.t - pg.gnss_pos
    e2 = torch.sum(r * _mv(pg.gnss_info, r), -1)
    k2 = pg.gnss_k2
    w = k2 / (k2 + e2)
    rho = 0.5 * k2 * torch.log1p(e2 / k2)
    Lam = w[:, None, None] * pg.gnss_info
    JtL = state.R.transpose(-1, -2) @ Lam
    m = pg.gnss_mask.to(dtype)
    _scatter_blocks(H, b, (15 * NWr + 3)[:, None] + ar(3), m[:, None, None] * (JtL @ state.R),
                    m[:, None] * -_mv(JtL, r))
    err = err + torch.sum(m * rho)

    # odometry body velocity (factors.py:150-166)
    RT = state.R.transpose(-1, -2)
    vb = _mv(RT, state.vel)
    r = vb - pg.odo_vel
    J = torch.cat([_hat(vb), RT], dim=-1)  # (NW, 3, 6) over [w, vel]
    A, rhs, e = _gauss_newton_terms(J, pg.odo_info.expand(NW, 3, 3), r, pg.odo_mask)
    # rows [15f..15f+3) (pose w) ++ [15f+6..15f+9) (vel)
    o_rows = torch.cat([(15 * NWr)[:, None] + ar(3), (15 * NWr + 6)[:, None] + ar(3)], dim=1)
    _scatter_blocks(H, b, o_rows, A, rhs)
    err = err + torch.sum(e)

    # marginal prior (LinearContainerFactor, factors.py:254-293) in dense
    # window form: 0.5 |dx|^2_H - v.dx with dx the local deviation from the
    # stored lin points; dims absent from the marginal have zero H rows/cols
    # and v entries, so their (arbitrary) deltas cancel
    if mgd is not None:
        lin = mgd.lin
        d_pose = _se3_local(lin[:, :9].reshape(NW, 3, 3), lin[:, 9:12], state.R, state.t)
        dvec = torch.cat([d_pose, state.vel - lin[:, 12:15], state.bias - lin[:, 15:21]], -1)
        dvec = (dvec * mgd.mask[:, None].to(dtype)).reshape(N)
        Hd = mgd.H @ dvec
        H = H + mgd.H
        b = b + mgd.v - Hd
        err = err + 0.5 * (dvec @ Hd) - mgd.v @ dvec

    # visual hessian (camera system converted to body upstream)
    dpose = _se3_local(vis_linR, vis_lint, state.R, state.t) * state.valid[:, None].to(dtype)
    dp6 = dpose.reshape(NW * 6)
    Hv = vis_H @ dp6
    pose_rows = ((15 * NWr)[:, None] + ar(6)).reshape(NW * 6)
    H = H.index_put((pose_rows[:, None], pose_rows[None, :]), vis_H, accumulate=True)
    b = b.index_put((pose_rows,), vis_v - Hv, accumulate=True)
    err = err + 0.5 * (dp6 @ Hv) - vis_v @ dp6

    if hold_empty:
        # hold unconstrained rows (invalid frames / untouched states)
        H = H + torch.diag((torch.diagonal(H) == 0.0).to(dtype))
    return H, b, err


def linearize(state: FgState, pg: PackedGraph, vis_H, vis_v, vis_linR, vis_lint,
              mgd: Optional[MargDense] = None, hold_empty: bool = True):
    """Dense normal equations over the padded window, the contract of
    :func:`linearize_plain`.  A CUDA input launches the hand kernel
    (``csrc/fg_linearize.cu``), which raises on what it does not take
    (:func:`_kernel_operands`); a CPU input takes the plain version."""
    if not state.t.is_cuda:
        return linearize_plain(state, pg, vis_H, vis_v, vis_linR, vis_lint, mgd, hold_empty)
    return _linearize_kernel(state, pg, vis_H, vis_v, vis_linR, vis_lint, mgd, hold_empty)


# the kernel's limits: a frame's displacements (21 floats) live in shared memory
MAX_FRAMES = 256
MAX_PRIORS = 64

# launches of the kernel, a plain integer (read around a capture by the LM)
LAUNCHES = {"fg_linearize": 0}

# the kernel's operands, in the order of its FgLinearizeArgs
KERNEL_OPERANDS = ("R", "t", "vel", "bias", "valid", *PackedGraph._fields, "vis_H", "vis_v",
                   "vis_linR", "vis_lint", "mgd_mask", "mgd_lin", "mgd_H", "mgd_v", "H", "b",
                   "err", "partial")

_KINDS = {"f": torch.float32, "b": torch.bool, "i": torch.int64}


def _kernel_operands(state: FgState, pg: PackedGraph, vis_H, vis_v, vis_linR, vis_lint,
                     mgd: Optional[MargDense]):
    """The kernel's inputs in its operand order (None for an absent
    marginal), each on the state's device with the shape and dtype it
    reads, made contiguous; and (NW, PP, PB).  Raises ValueError on what the
    kernel does not take: a window outside [2, MAX_FRAMES] frames, more than
    MAX_PRIORS priors of a kind, or another dtype (f32; masks bool; prior
    frames int64)."""
    NW, PP, PB = state.R.shape[0], pg.pp_mask.shape[0], pg.pb_mask.shape[0]
    if not (2 <= NW <= MAX_FRAMES and PP <= MAX_PRIORS and PB <= MAX_PRIORS):
        raise ValueError(f"linearize: the kernel takes 2..{MAX_FRAMES} frames and at most "
                         f"{MAX_PRIORS} priors of a kind, not NW={NW}, PP={PP}, PB={PB}")
    N = 15 * NW
    spec = [("R", (NW, 3, 3), "f"), ("t", (NW, 3), "f"), ("vel", (NW, 3), "f"),
            ("bias", (NW, 6), "f"), ("valid", (NW,), "b"), *_graph_spec(NW, PP, PB),
            ("vis_H", (6 * NW, 6 * NW), "f"), ("vis_v", (6 * NW,), "f"),
            ("vis_linR", (NW, 3, 3), "f"), ("vis_lint", (NW, 3), "f")]
    given = [*state, *pg, vis_H, vis_v, vis_linR, vis_lint]
    if mgd is not None:
        spec += [("mgd_mask", (NW,), "b"), ("mgd_lin", (NW, 21), "f"), ("mgd_H", (N, N), "f"),
                 ("mgd_v", (N,), "f")]
        given += list(mgd)
    dev = state.t.device
    out = []
    for (name, shape, kind), x in zip(spec, given):
        if x.dtype != _KINDS[kind] or tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"linearize: {name} is {x.dtype} {tuple(x.shape)} on {x.device}; "
                             f"the kernel takes {_KINDS[kind]} {shape} on {dev}")
        out.append(x.contiguous())
    return out + [None] * (len(KERNEL_OPERANDS) - 4 - len(out)), (NW, PP, PB)


def _linearize_kernel(state, pg, vis_H, vis_v, vis_linR, vis_lint, mgd, hold_empty):
    """One :func:`linearize` on the card: the kernel and its error sum on
    the current stream, outputs from ``torch.empty`` (so the launch can be
    captured in a CUDA graph), no host synchronisation."""
    from ..utils.cuda_build import load_kernel_library

    ins, (NW, PP, PB) = _kernel_operands(state, pg, vis_H, vis_v, vis_linR, vis_lint, mgd)
    lib = load_kernel_library("fg_linearize")
    dev = state.t.device
    N = 15 * NW
    shapes = ((N, N), (N,), (), (NW,))  # H, b, err and the bands' shares of err
    outs = [torch.empty(shape, dtype=torch.float32, device=dev) for shape in shapes]
    ptrs = (ctypes.c_void_p * len(KERNEL_OPERANDS))(
        *(None if x is None else x.data_ptr() for x in (*ins, *outs)))
    rc = lib.fg_linearize_launch(ctypes.addressof(ptrs), len(ptrs), NW, PP, PB,
                                 int(mgd is not None), int(hold_empty),
                                 torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fg_linearize: the launch failed with code {rc}")
    LAUNCHES["fg_linearize"] += 1
    return tuple(outs[:3])


# ---------------------------------------------------------------------------
# Levenberg-Marquardt (fusion.graph.LevenbergMarquardt semantics)
# ---------------------------------------------------------------------------


def _retract_state(state: FgState, d: torch.Tensor) -> FgState:
    NW = state.R.shape[0]
    d3 = d.reshape(NW, 15)
    R, t = _se3_retract(state.R, state.t, d3[:, :6])
    return FgState(_orthonormalize(R), t, state.vel + d3[:, 6:9], state.bias + d3[:, 9:15],
                   state.valid)


def _select_state(accept: torch.Tensor, a: FgState, b: FgState) -> FgState:
    return FgState(*(torch.where(accept, y, x) for x, y in zip(a[:4], b[:4])), a.valid)


class LMStep(NamedTuple):
    state: FgState
    H: torch.Tensor
    b: torch.Tensor
    lam: torch.Tensor
    err: torch.Tensor
    done: torch.Tensor  # bool (0-d)
    ok: torch.Tensor    # the factorization succeeded and the step is finite
    accept: torch.Tensor


def lm_step(st: FgState, H, b, lam, err, relin, lambda_factor=10.0, lambda_max=1e5,
            relative_tol=1e-5, absolute_tol=1e-5) -> LMStep:
    """One damped Gauss-Newton iteration (graph.py:156-212): accept on
    improvement / raise lambda on rejection; the candidate's (H, b, err)
    from ``relin`` doubles as the next iteration's normal equations."""
    Hd = H + lam * torch.diag(torch.diagonal(H))
    L, info = torch.linalg.cholesky_ex(Hd)
    d = torch.cholesky_solve(b[:, None], L)[:, 0]
    ok = (info == 0) & torch.all(torch.isfinite(d))
    cand = _retract_state(st, torch.where(ok, d, torch.zeros_like(d)))
    Hc, bc, errc = relin(cand)
    accept = ok & (errc < err)
    rel = torch.abs(err - errc) / torch.clamp(torch.abs(err), min=1e-12)
    # plateau: in f32 a converged solve often rejects on errc == err (strict
    # <); climbing the whole lambda ladder would cost ~10 iterations for the
    # same fixed point -- treat it as converged
    converged = (rel < relative_tol) | (torch.abs(err - errc) < absolute_tol)
    lam2 = torch.where(accept, torch.clamp(lam / lambda_factor, min=1e-10), lam * lambda_factor)
    stalled = (~accept) & (lam2 > lambda_max)
    return LMStep(_select_state(accept, st, cand), torch.where(accept, Hc, H),
                  torch.where(accept, bc, b), lam2, torch.where(accept, errc, err),
                  converged | stalled, ok, accept)


def _lm_iterate(st: FgState, H, b, lam, err, done, its, relin, *step_consts):
    """One launched LM iteration: :func:`lm_step`, with everything frozen
    where ``done`` already holds (a masked iteration writes nothing).
    Returns (state, H, b, lam, err, done, its)."""
    s = lm_step(st, H, b, lam, err, relin, *step_consts)
    live = ~done
    H, b, lam, err = (torch.where(live, new, old)
                      for new, old in ((s.H, H), (s.b, b), (s.lam, lam), (s.err, err)))
    return (_select_state(live, st, s.state), H, b, lam, err, done | s.done,
            its + live.long())


def _lm_tensors(state, pg, vis_H, vis_v, vis_linR, vis_lint, mgd) -> list:
    """An LM pass's inputs as one list of tensors (:func:`_lm_inputs`
    rebuilds them)."""
    return [*state, *pg, vis_H, vis_v, vis_linR, vis_lint, *(mgd or ())]


def _lm_inputs(ts: list):
    n_s, n_g = len(FgState._fields), len(PackedGraph._fields)
    n = n_s + n_g + 4
    mgd = MargDense(*ts[n:]) if len(ts) > n else None
    return (FgState(*ts[:n_s]), PackedGraph(*ts[n_s:n_s + n_g]), *ts[n_s + n_g:n], mgd)


class _EagerLM:
    """An LM pass launched op by op (the CPU).  ``kernel``: the last
    iteration's relinearization was the hand kernel."""

    replayed = False
    kernel = False

    def __init__(self, ts: list, lambda_initial: float, step_consts: tuple):
        state, pg, vis_H, vis_v, vis_linR, vis_lint, mgd = _lm_inputs(ts)
        self.relin = lambda st: linearize(st, pg, vis_H, vis_v, vis_linR, vis_lint, mgd)
        self.step_consts = step_consts
        dev = state.t.device
        self.st = state
        self.H, self.b, self.err = self.relin(state)
        self.lam = torch.full((), lambda_initial, dtype=state.t.dtype, device=dev)
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.its = torch.zeros((), dtype=torch.int64, device=dev)

    def iterate(self):
        n = LAUNCHES["fg_linearize"]
        (self.st, self.H, self.b, self.lam, self.err, self.done,
         self.its) = _lm_iterate(self.st, self.H, self.b, self.lam, self.err, self.done,
                                 self.its, self.relin, *self.step_consts)
        self.kernel = LAUNCHES["fg_linearize"] > n

    def result(self, valid: torch.Tensor):
        return FgState(*self.st[:4], valid), (self.err, self.its)


class _ReplayedLM(_EagerLM):
    """An LM pass on the card, replayed from two captured CUDA graphs: one
    relinearizes the pass's starting state and resets lambda, ``done`` and
    the count, the other is one :func:`_lm_iterate` that ends by copying its
    outputs over its inputs, so each replay continues from the last.  Both
    read and write one set of static tensors: :meth:`load` copies a pass's
    inputs in, :meth:`result` clones the solved state out.  Built (the
    graphs captured) at the first pass of its key, reused by every later
    one.  ``kernel``: the iteration's graph holds the hand kernel (the
    kernel's launch count moved while it was captured)."""

    replayed = True

    def __init__(self, ts: list, lambda_initial: float, step_consts: tuple):
        self.ins = [t.clone() for t in ts]
        super().__init__(self.ins, lambda_initial, step_consts)
        self.lambda_initial = lambda_initial
        # warm up on the capture stream (library handles, workspaces), then
        # capture; the warm-up's writes are overwritten by the first load
        dev = ts[0].device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._iterate()
            self.start = self._capture(self._start)
            n = LAUNCHES["fg_linearize"]
            self.step = self._capture(self._iterate)
            self.kernel = LAUNCHES["fg_linearize"] > n
        torch.cuda.current_stream(dev).wait_stream(side)

    @staticmethod
    def _capture(fn) -> torch.cuda.CUDAGraph:
        g = torch.cuda.CUDAGraph()
        g.capture_begin(capture_error_mode="thread_local")
        try:
            fn()
        finally:
            g.capture_end()
        return g

    def _start(self):
        H, b, err = self.relin(self.st)
        for dst, src in ((self.H, H), (self.b, b), (self.err, err)):
            dst.copy_(src)
        self.lam.fill_(self.lambda_initial)
        self.done.zero_()
        self.its.zero_()

    def _iterate(self):
        loop = (*self.st[:4], self.H, self.b, self.lam, self.err, self.done, self.its)
        st, *rest = _lm_iterate(self.st, self.H, self.b, self.lam, self.err, self.done,
                                self.its, self.relin, *self.step_consts)
        for dst, src in zip(loop, (*st[:4], *rest)):
            dst.copy_(src)

    def load(self, ts: list):
        for dst, src in zip(self.ins, ts):
            dst.copy_(src)
        self.start.replay()

    def iterate(self):
        self.step.replay()

    def result(self, valid: torch.Tensor):
        return (FgState(*(x.clone() for x in self.st[:4]), valid),
                (self.err.clone(), self.its.clone()))


# the card's captured LM passes, by what fixes their graphs: the device, the
# constants baked into them and the shape and dtype of every input (the
# window, prior and marginal sizes)
_REPLAYED = {}


def lm_optimize(state: FgState, pg: PackedGraph, vis_H, vis_v, vis_linR, vis_lint,
                mgd: Optional[MargDense] = None, lambda_initial=1e-5, lambda_factor=10.0,
                lambda_max=1e5, max_iterations=24, relative_tol=1e-5, absolute_tol=1e-5,
                poll: Optional[FlagPoll] = None):
    """Damped Gauss-Newton on the packed window, at most ``max_iterations``
    iterations, stopping at convergence or stall.  Returns (state, (err,
    iterations)).

    On the card each iteration is a replay of one captured CUDA graph
    (:class:`_ReplayedLM`); elsewhere it is launched op by op.  ``done`` goes
    to ``poll`` (a :class:`~dbaf_tpu_torch.utils.device.FlagPoll`; by
    default a blocking one, one host read per iteration) after each
    iteration, and the loop stops once a post has answered True.  With a
    non-blocking poll the loop runs at most one iteration ahead of its
    newest answer: before launching iteration k + 1 it waits for iteration
    k - 1's post where that has not answered.  Iterations launched before
    the answer is in are masked: the state, system, lambda and error stay
    as they were once done, as after the JAX ``while_loop``.  The realized
    count is a 0-d device tensor."""
    poll = poll or FlagPoll(blocking=True)
    lm = _lm_pass(_lm_tensors(state, pg, vis_H, vis_v, vis_linR, vis_lint, mgd),
                  lambda_initial, (lambda_factor, lambda_max, relative_tol, absolute_tol))
    TRACER.lm_passes += 1
    poll.reset()
    for _ in range(max_iterations):
        if poll.value_within(1):
            break
        lm.iterate()
        TRACER.lm_launched += 1
        TRACER.lm_replayed += lm.replayed
        TRACER.lm_kernel_linearized += lm.kernel
        poll.post(lm.done)
    return lm.result(state.valid)


def _lm_pass(ts: list, lambda_initial: float, step_consts: tuple):
    """A pass at its start (relinearized): on the card its key's
    :class:`_ReplayedLM`, built at the key's first pass, loaded with
    ``ts``; elsewhere an :class:`_EagerLM`."""
    if not ts[0].is_cuda:
        return _EagerLM(ts, lambda_initial, step_consts)
    key = (ts[0].device, lambda_initial, step_consts, tuple((t.shape, t.dtype) for t in ts))
    lm = _REPLAYED.get(key)
    if lm is None:
        lm = _REPLAYED[key] = _ReplayedLM(ts, lambda_initial, step_consts)
    lm.load(ts)
    return lm


# ---------------------------------------------------------------------------
# the coupled round: hessian -> LM -> retract, n_iters times
# ---------------------------------------------------------------------------


def _body_system(S, v, A, NW: int):
    """Camera-tangent reduced system -> body tangent (BA2GTSAM)."""
    H4 = S[: NW * 6, : NW * 6].reshape(NW, 6, NW, 6)
    Hb = torch.einsum("ca,icjd,db->iajb", A, H4, A).reshape(NW * 6, NW * 6)
    vb = torch.einsum("ca,ic->ia", A, v[: NW * 6].reshape(NW, 6)).reshape(-1)
    return Hb, vb


def coupled_rounds_body(poses_buf, disps_buf, damping_buf, intrinsics, target, weight,
                        ii_d, jj_d, mask, t0, n, fg: FgState, pg: PackedGraph,
                        mgd: MargDense, A, P: int, NW: int, n_iters: int = 2,
                        eps_damping: float = 1e-7, poll: Optional[FlagPoll] = None):
    """The multi-sensor DBA call of depth_video.py:524-558: reduced camera
    system -> body conversion -> factor-graph LM -> camera dx -> depth
    back-substitution and retraction, ``n_iters`` times with
    relinearization.  Poses and disparities are updated in place.  ``t0``
    and ``n`` are ints or 0-d device tensors; ``poll`` goes to
    :func:`lm_optimize`.  Returns (poses_buf, disps_buf, fg, realized LM
    iterations per pass)."""
    from ..ops import dba

    S, v = dba.coupled_hessian_full(poses_buf, disps_buf, damping_buf, intrinsics, target,
                                    weight, ii_d, jj_d, mask, t0, n, P=P,
                                    eps_damping=eps_damping)
    lm_its = []
    for it in range(n_iters):
        Hb, vb = _body_system(S, v, A, NW)
        fg2, (_, lm_it) = lm_optimize(fg, pg, Hb, vb, fg.R, fg.t, mgd, poll=poll)
        lm_its.append(lm_it)
        dxb = _se3_local(fg.R, fg.t, fg2.R, fg2.t) * fg.valid[:, None].to(poses_buf.dtype)
        dx_full = torch.zeros((P, 6), dtype=poses_buf.dtype, device=poses_buf.device)
        dx_full[:NW] = torch.einsum("ab,ib->ia", A, dxb)
        poses_buf, disps_buf, S, v = dba.coupled_retract_full(
            poses_buf, disps_buf, damping_buf, intrinsics, target, weight, ii_d, jj_d, mask,
            t0, n, dx_full, P=P, eps_damping=eps_damping, with_hessian=(it + 1 < n_iters))
        fg = fg2
    return poses_buf, disps_buf, fg, lm_its


# ---------------------------------------------------------------------------
# device sliding-window marginalization
# ---------------------------------------------------------------------------


def _cho_solve_or_nan(L, info, B):
    """Cholesky solve that gives NaN after a failed factorization, as
    ``cho_solve`` of a NaN factor does."""
    X = torch.cholesky_solve(B, L)
    return torch.where(info == 0, X, torch.full_like(X, float("nan")))


def marginalize_window_body(poses_buf, disps_buf, damping_buf, intrinsics, marg_target,
                            marg_weight, ii_d, jj_d, mask_m, s0, fg: FgState,
                            pg: PackedGraph, mgd_old: MargDense, A, m, k_end,
                            P: int, NW: int, eps_damping: float = 1e-7) -> MargDense:
    """The numeric core of coupled._marginalize on the device: visual
    hessian of the marginalized edges -> body conversion -> linearize
    {IMU/priors/GNSS/odometry on the eliminated frames} + old marginal at
    the current states -> Schur-eliminate the first ``m`` frame blocks ->
    re-base to the new window origin (fusion.graph.marginalize_out
    semantics; dims absent from the host graph carry zero rows).  ``s0``,
    ``m`` and ``k_end`` are ints or 0-d device tensors (no host read)."""
    from ..ops import dba

    N = NW * 15
    dev = poses_buf.device
    ar15 = torch.arange(N, device=dev)
    arW = torch.arange(NW, device=dev)

    S, v = dba.coupled_hessian_full(poses_buf, disps_buf, damping_buf, intrinsics, marg_target,
                                    marg_weight, ii_d, jj_d, mask_m, s0, k_end, P=P,
                                    eps_damping=eps_damping)
    any_edge = torch.any(mask_m).to(S.dtype)
    # first-pose diagonal stabilization, only when visual info exists
    # (coupled.py _marginalize: H[:6] diag += 0.00025)
    S = S + 0.00025 * any_edge * torch.diag(
        (torch.arange(S.shape[0], device=dev) < 6).to(S.dtype))
    Hb, vb = _body_system(S, v, A, NW)

    # restrict the packed factors to the eliminated frames (the host
    # marginalization graph holds exactly the factors anchored at frames
    # < t0: coupled.py:214-246)
    pgm = pg._replace(
        imu_mask=pg.imu_mask & (arW[:-1] < m),
        pp_mask=pg.pp_mask & (pg.pp_frame < m),
        pb_mask=pg.pb_mask & (pg.pb_frame < m),
        gnss_mask=pg.gnss_mask & (arW < m),
        odo_mask=pg.odo_mask & (arW < m),
    )
    H, b, _ = linearize(fg, pgm, Hb, vb, fg.R, fg.t, mgd_old, hold_empty=False)

    # Schur-eliminate rows [0, 15m) on the Jacobi-scaled system (unit
    # diagonal): IMU information spans ~10 orders of magnitude across dims,
    # and in f32 a raw Cholesky of the mixed-scale block loses the
    # small-pivot dims entirely
    rm = ar15 < 15 * m
    keep = (~rm) & (ar15 < 15 * k_end)
    rmf = rm.to(H.dtype)
    kf = keep.to(H.dtype)
    dsc = torch.sqrt(torch.abs(torch.diagonal(H)))
    live = dsc > 1e-20
    one = torch.ones_like(dsc)
    dinv = torch.where(live, 1.0 / torch.where(live, dsc, one), one)
    Hn = H * dinv[:, None] * dinv[None, :]
    bn = b * dinv
    # unit pivots on eliminated dims (zero-information dims included),
    # identity rows elsewhere; 1e-6 relative reg (the host adds 1e-10
    # absolute in f64)
    Hrr = Hn * rmf[:, None] * rmf[None, :] + torch.diag(
        torch.where(rm, 1e-6 + torch.where(live, 0.0, 1.0), 1.0).to(H.dtype))
    Hrk = Hn * rmf[:, None] * kf[None, :]
    L, info = torch.linalg.cholesky_ex(Hrr)
    X = _cho_solve_or_nan(L, info, Hrk)
    xb = _cho_solve_or_nan(L, info, (bn * rmf)[:, None])[:, 0]
    Hmn = Hn * kf[:, None] * kf[None, :] - Hrk.T @ X
    bmn = bn * kf - Hrk.T @ xb
    Hm = Hmn * dsc[:, None] * dsc[None, :]
    bm = bmn * dsc

    # re-base kept slots to the new origin t0 = s0 + m (torch.roll by -15m
    # as a gather, so m may live on the device)
    src = (ar15 + 15 * m) % N
    Hm = Hm[src][:, src]
    bm = bm[src]
    lf = (ar15 < 15 * (k_end - m)).to(H.dtype)
    Hm = Hm * lf[:, None] * lf[None, :]
    bm = bm * lf
    lin = flatten_state(fg).reshape(NW, 21)[(arW + m) % NW]
    mask = arW < (k_end - m)
    lin = torch.where(mask[:, None], lin, marg_identity_lin(NW, H.dtype, dev))
    return MargDense(mask, lin, Hm, bm)


def marg_identity_lin(NW: int, dtype, device) -> torch.Tensor:
    """marg_identity_np(NW).lin built on the device (identity rotations,
    zero elsewhere) with no host->device copy."""
    eye9 = torch.eye(3, dtype=dtype, device=device).reshape(1, 9).expand(NW, 9)
    return torch.cat([eye9, torch.zeros((NW, 12), dtype=dtype, device=device)], dim=1)


# ---------------------------------------------------------------------------
# host -> device packing (numpy, f32)
# ---------------------------------------------------------------------------


def pack_graph(msba, t0: int, t1: int, NW: int, PP: int = 4, PB: int = 4, device=None):
    """The window graph as a PackedGraph on ``device`` (one upload per
    field; tests).  None on a capacity miss."""
    arrs = pack_graph_np(msba, t0, t1, NW, PP, PB)
    if arrs is None:
        return None
    return unflatten_graph(torch.as_tensor(flatten_graph_np(arrs, NW, PP, PB), device=device),
                           NW, PP, PB)


def pack_graph_flat(msba, t0: int, t1: int, NW: int, PP: int = 4, PB: int = 4):
    """The window graph as one flat f32 host buffer (single upload;
    unflatten_graph on the device).  None on a capacity miss."""
    arrs = pack_graph_np(msba, t0, t1, NW, PP, PB)
    if arrs is None:
        return None
    return flatten_graph_np(arrs, NW, PP, PB)


def pack_graph_np(msba, t0: int, t1: int, NW: int, PP: int = 4, PB: int = 4):
    """Pack the MultiSensorBA window graph (slam/coupled.py ``base``) into
    fixed-capacity numpy arrays.  None if the layout exceeds a capacity
    (the caller falls back to the host solver)."""
    from ..slam.coupled import GNSS_NOISE, ODO_NOISE
    from ..utils import geodesy
    from .factors import PriorPose, PriorVec

    n = t1 - t0
    if n > NW:
        return None
    f32 = np.float32
    NF = NW - 1
    z = np.zeros
    imu = dict(
        imu_mask=z(NF, bool), imu_dR=np.tile(np.eye(3, dtype=f32), (NF, 1, 1)),
        imu_dv=z((NF, 3), f32), imu_dp=z((NF, 3), f32), imu_dt=z(NF, f32),
        imu_dRg=z((NF, 3, 3), f32), imu_dvg=z((NF, 3, 3), f32),
        imu_dva=z((NF, 3, 3), f32), imu_dpg=z((NF, 3, 3), f32),
        imu_dpa=z((NF, 3, 3), f32), imu_bias0=z((NF, 6), f32),
        imu_info=z((NF, 15, 15), f32),
    )
    g_vec = np.array([0.0, 0.0, -9.807], f32)
    if not msba.ignore_imu:
        for i in range(t0 + 1, t1):
            k = i - 1 - t0
            pim = msba.state.preintegrations[i - 1]
            imu["imu_mask"][k] = True
            imu["imu_dR"][k] = pim.dR
            imu["imu_dv"][k] = pim.dv
            imu["imu_dp"][k] = pim.dp
            imu["imu_dt"][k] = pim.dt
            imu["imu_dRg"][k] = pim.dRg
            imu["imu_dvg"][k] = pim.dvg
            imu["imu_dva"][k] = pim.dva
            imu["imu_dpg"][k] = pim.dpg
            imu["imu_dpa"][k] = pim.dpa
            imu["imu_bias0"][k] = pim.bias
            imu["imu_info"][k] = pim.noise_information()
            g_vec = pim.params.g_vec.astype(f32)

    pp = dict(pp_mask=z(PP, bool), pp_frame=z(PP, np.int32),
              pp_R=np.tile(np.eye(3, dtype=f32), (PP, 1, 1)),
              pp_t=z((PP, 3), f32), pp_info=z((PP, 6, 6), f32))
    pb = dict(pb_mask=z(PB, bool), pb_frame=z(PB, np.int32),
              pb_prior=z((PB, 6), f32), pb_info=z((PB, 6, 6), f32))
    npp = npb = 0
    for i in sorted(msba.prior_factor_map.keys()):
        if not (t0 <= i < t1):
            continue
        for fct in msba.prior_factor_map[i]:
            if isinstance(fct, PriorPose):
                if npp >= PP:
                    return None
                pp["pp_mask"][npp] = True
                pp["pp_frame"][npp] = i - t0
                pp["pp_R"][npp] = fct.prior.R
                pp["pp_t"][npp] = fct.prior.t
                pp["pp_info"][npp] = fct.noise.information
                npp += 1
            elif isinstance(fct, PriorVec) and len(fct.prior) == 6:
                if npb >= PB:
                    return None
                pb["pb_mask"][npb] = True
                pb["pb_frame"][npb] = i - t0
                pb["pb_prior"][npb] = fct.prior
                pb["pb_info"][npb] = fct.noise.information
                npb += 1
            else:
                return None  # unsupported prior layout

    gnss = dict(gnss_mask=z(NW, bool), gnss_pos=z((NW, 3), f32))
    if msba.gnss_init_t1 > 0:
        for i in range(t0, t1):
            if msba.state.gnss_valid[i]:
                p = geodesy.Cen(msba.ten0).T @ (msba.state.gnss_position[i] - msba.ten0)
                p = p - msba.state.wTbs[i].R @ msba.tbg
                gnss["gnss_mask"][i - t0] = True
                gnss["gnss_pos"][i - t0] = p
    odo = dict(odo_mask=z(NW, bool), odo_vel=z((NW, 3), f32))
    for i in range(t0, t1):
        if msba.state.odo_valid[i]:
            odo["odo_mask"][i - t0] = True
            odo["odo_vel"][i - t0] = msba.state.odo_vel[i]

    return dict(**imu, g_vec=g_vec, **pp, **pb, **gnss,
                gnss_info=GNSS_NOISE.information.astype(f32),
                gnss_k2=np.asarray(GNSS_NOISE.cauchy_k ** 2, f32),
                **odo, odo_info=ODO_NOISE.information.astype(f32))


def marg_dense_to_factor(md, t0: int):
    """Pulled :class:`MargDense` (numpy) -> host LinearContainerFactor at
    global frame keys (origin ``t0``).  Dims the device marginal never
    touched keep zero rows -- the dense encoding of an absent key."""
    from .factors import B, LinearContainerFactor, V, X
    from .se3np import Pose

    frames = np.nonzero(np.asarray(md.mask))[0]
    if len(frames) == 0:
        return None
    keys, dims, lin, idx = [], [], {}, []
    for f in frames:
        i = t0 + int(f)
        row = np.asarray(md.lin[f], np.float64)
        keys += [X(i), V(i), B(i)]
        dims += [6, 3, 6]
        lin[X(i)] = Pose(row[:9].reshape(3, 3), row[9:12])
        lin[V(i)] = row[12:15]
        lin[B(i)] = row[15:21]
        idx += list(range(15 * int(f), 15 * int(f) + 15))
    ix = np.asarray(idx, int)
    H = np.asarray(md.H, np.float64)[np.ix_(ix, ix)]
    v = np.asarray(md.v, np.float64)[ix]
    return LinearContainerFactor(keys, dims, H, v, lin)


def marg_dense_np(mf, t0: int, t1: int, NW: int):
    """Host LinearContainerFactor -> dense window :class:`MargDense` (or
    None when a key falls outside [t0, t1))."""
    md = marg_identity_np(NW)
    if mf is None:
        return md
    offs = np.cumsum([0] + list(mf.dims))
    rows = []
    for k, key in enumerate(mf.keys):
        typ, idx = key[0], int(key[1:])
        if not (t0 <= idx < t1):
            return None
        f = idx - t0
        md.mask[f] = True
        lp = mf.lin_point[key]
        if typ == "x":
            md.lin[f, :9] = lp.R.reshape(9)
            md.lin[f, 9:12] = lp.t
            base, dim = 15 * f, 6
        elif typ == "v":
            md.lin[f, 12:15] = lp
            base, dim = 15 * f + 6, 3
        else:
            md.lin[f, 15:21] = lp
            base, dim = 15 * f + 9, 6
        if dim != mf.dims[k]:
            return None
        rows.append((base, offs[k], dim))
    for (ra, sa, da) in rows:
        md.v[ra: ra + da] = mf.v[sa: sa + da]
        for (rb, sb, db) in rows:
            md.H[ra: ra + da, rb: rb + db] = mf.H[sa: sa + da, sb: sb + db]
    return md


def pack_state_np(msba, t0: int, t1: int, NW: int):
    f32 = np.float32
    R = np.tile(np.eye(3, dtype=f32), (NW, 1, 1))
    t = np.zeros((NW, 3), f32)
    vel = np.zeros((NW, 3), f32)
    bias = np.zeros((NW, 6), f32)
    valid = np.zeros(NW, bool)
    for i in range(t0, t1):
        f = i - t0
        R[f] = msba.state.wTbs[i].R
        t[f] = msba.state.wTbs[i].t
        vel[f] = msba.state.vs[i]
        bias[f] = msba.state.bs[i]
        valid[f] = True
    return R, t, vel, bias, valid


def pack_state(msba, t0: int, t1: int, NW: int, device=None) -> FgState:
    return FgState(*(torch.as_tensor(a, device=device)
                     for a in pack_state_np(msba, t0, t1, NW)))


def pack_state_flat(msba, t0: int, t1: int, NW: int) -> np.ndarray:
    """One flat (NW*21,) f32 host buffer; unflatten_state on the device
    (valid is derived from the live count n = t1 - t0)."""
    R, t, vel, bias, _ = pack_state_np(msba, t0, t1, NW)
    return flatten_state_np(R, t, vel, bias)
