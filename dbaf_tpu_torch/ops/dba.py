"""Dense bundle adjustment: per-edge linearization, Schur solve, retraction.

Port of ``dbaf_tpu/ops/dba.py`` (the visual solver; the coupled BACore
surface comes with the multi-sensor slice).  The reference's per-edge
Hessian kernel and CPU-assembled Schur complement
(droid_kernels.cu:220-468, 993-1512) become batched Gram products on a
window-local dense pose system:

* ``segment_sum`` is ``index_add_``; on the card its atomic order varies
  from run to run, so sums differ in their last bits between runs;
* the pairwise path forms the Schur complement ``S = A - E Q E^T`` from
  one Gram product of the stacked per-edge couplings;
* f32 products run in full f32 (TF32 is off, see
  :func:`dbaf_tpu_torch.utils.device.configure_cuda_numerics`).

Quirk parity with the reference: weights scale by 0.001, stereo edges add
depth terms only, damping goes on the Schur complement, and the depth
back-substitution skips the first active pose's step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..parallel import collectives as col
from . import lie
from . import projective as pj


class EdgeSystem(NamedTuple):
    H: torch.Tensor       # (E, 12, 12)
    v: torch.Tensor       # (E, 12)
    Ei: torch.Tensor      # (E, 6, D)
    Ej: torch.Tensor      # (E, 6, D)
    C: torch.Tensor       # (E, D)
    w: torch.Tensor       # (E, D)
    coords: torch.Tensor  # (E, H, W, 2)


def build_edge_system(poses, disps, intrinsics, targets, weights, ii, jj, edge_mask) -> EdgeSystem:
    """Linearize the weighted reprojection residual per edge
    (droid_kernels.cu:325-419): depth terms use the validity-masked weight,
    pose terms the stereo-zeroed one."""
    E = ii.shape[0]
    D = disps.shape[-2] * disps.shape[-1]
    J = pj.projection_jacobians(poses, disps, intrinsics, ii, jj)
    dt = targets.dtype
    r = (targets - J.coords).reshape(E, D, 2)
    w_depth = (
        0.001 * weights.reshape(E, D, 2)
        * J.valid.reshape(E, D, 1).to(dt)
        * edge_mask[:, None, None].to(dt)
    )
    stereo = (ii == jj)[:, None, None].to(dt)
    w_pose = w_depth * (1.0 - stereo)

    Ji = J.Ji.reshape(E, D, 2, 6)
    Jj = J.Jj.reshape(E, D, 2, 6)
    Jz = J.Jz.reshape(E, D, 2)
    Jx = torch.cat([Ji, Jj], dim=-1)  # (E, D, 2, 12)

    wJx = w_pose[..., None] * Jx
    Hm = torch.einsum("edkc,edkf->ecf", wJx, Jx)
    v = torch.einsum("edkc,edk->ec", wJx, r)
    wJz_pose = w_pose * Jz
    Ei = torch.einsum("edk,edkc->ecd", wJz_pose, Ji)
    Ej = torch.einsum("edk,edkc->ecd", wJz_pose, Jj)
    C = torch.sum(w_depth * Jz * Jz, dim=-1)
    w_rhs = torch.sum(w_depth * r * Jz, dim=-1)
    return EdgeSystem(H=Hm, v=v, Ei=Ei, Ej=Ej, C=C, w=w_rhs, coords=J.coords)


def _segment_sum(values: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + values.shape[1:], dtype=values.dtype, device=values.device)
    return out.index_add_(0, idx, values)


def _segment_matrix(blocks, rows, cols, P: int) -> torch.Tensor:
    """Scatter-add (N, 6, 6) blocks into (P, P, 6, 6); out-of-range indices
    drop (droid_kernels.cu:1190-1200)."""
    valid = (rows >= 0) & (cols >= 0) & (rows < P) & (cols < P)
    idx = torch.where(valid, rows * P + cols, torch.full_like(rows, P * P))
    vals = torch.where(valid[:, None, None], blocks, torch.zeros_like(blocks))
    return _segment_sum(vals, idx, P * P + 1)[: P * P].reshape(P, P, 6, 6)


def _segment_vector(vecs, rows, P: int) -> torch.Tensor:
    valid = (rows >= 0) & (rows < P)
    idx = torch.where(valid, rows, torch.full_like(rows, P))
    vals = torch.where(valid[:, None], vecs, torch.zeros_like(vecs))
    return _segment_sum(vals, idx, P + 1)[:P]


def _edge_pose_indices(ii, jj, nfixed, nactive):
    def loc(x):
        return torch.where((x >= nfixed) & (x < nactive), x, torch.full_like(x, -1))

    return loc(ii), loc(jj)


def _finish_depth_diag(C, w, eta, depth_active, disps, disps_sens, alpha):
    """Depth damping + optional depth-sensor prior (ba_cuda :1474-1480)."""
    P, D = C.shape
    if disps_sens is not None and disps is not None:
        m = (disps_sens.reshape(P, D) > 0).to(C.dtype)
        C = C + m * alpha + (1.0 - m) * eta.reshape(P, D)
        w = w - m * alpha * (disps.reshape(P, D) - disps_sens.reshape(P, D))
    else:
        C = C + eta.reshape(P, D)
    C = torch.where(depth_active[:, None], C, torch.ones_like(C))
    w = torch.where(depth_active[:, None], w, torch.zeros_like(w))
    return C, w


class WindowSystem(NamedTuple):
    A: torch.Tensor   # (P*6, P*6)
    b: torch.Tensor   # (P*6,)
    Ew: torch.Tensor  # (P*6, P*D)
    C: torch.Tensor   # (P, D)
    w: torch.Tensor   # (P, D)
    pose_active: torch.Tensor


def assemble_window_system(sys_e: EdgeSystem, ii, jj, P: int, nfixed, nactive, eta,
                           disps=None, disps_sens=None, alpha: float = 0.05) -> WindowSystem:
    """Dense window system with the explicit pose-depth coupling ``Ew``
    (the motion-only path and the test oracle of the pairwise path)."""
    D = sys_e.C.shape[-1]
    dev = ii.device
    li, lj = _edge_pose_indices(ii, jj, nfixed, nactive)
    Hm = sys_e.H
    A = (
        _segment_matrix(Hm[:, :6, :6], li, li, P)
        + _segment_matrix(Hm[:, :6, 6:], li, lj, P)
        + _segment_matrix(Hm[:, 6:, :6], lj, li, P)
        + _segment_matrix(Hm[:, 6:, 6:], lj, lj, P)
    )
    b = _segment_vector(sys_e.v[:, :6], li, P) + _segment_vector(sys_e.v[:, 6:], lj, P)

    slot = torch.arange(P, device=dev)
    depth_active = slot < nactive
    ki = torch.clamp(ii, 0, P - 1)
    C = _segment_sum(sys_e.C, ki, P)
    w = _segment_sum(sys_e.w, ki, P)
    C, w = _finish_depth_diag(C, w, eta, depth_active, disps, disps_sens, alpha)

    def scatter_E(blocks, rows):
        valid = rows >= 0
        idx = torch.where(valid, rows * P + ki, torch.full_like(rows, P * P))
        vals = torch.where(valid[:, None, None], blocks, torch.zeros_like(blocks))
        return _segment_sum(vals, idx, P * P + 1)[: P * P].reshape(P, P, 6, D)

    Ew = scatter_E(sys_e.Ei, li) + scatter_E(sys_e.Ej, lj)
    Ew = Ew.permute(0, 2, 1, 3).reshape(P * 6, P * D)

    pose_active = (slot >= nfixed) & (slot < nactive)
    A = A.permute(0, 2, 1, 3).reshape(P * 6, P * 6)
    pa6 = pose_active[:, None].expand(-1, 6).reshape(-1)
    zero = torch.zeros((), dtype=A.dtype, device=dev)
    A = torch.where(pa6[:, None] & pa6[None, :], A, zero)
    b = torch.where(pa6, b.reshape(P * 6), zero)
    Ew = torch.where(pa6[:, None], Ew, zero)
    return WindowSystem(A=A, b=b, Ew=Ew, C=C, w=w, pose_active=pose_active)


def reduced_camera_system(ws: WindowSystem) -> Tuple[torch.Tensor, torch.Tensor]:
    """``S = A - E Q E^T``, ``v_r = b - E Q w`` with Q = 1/C."""
    KD = ws.Ew.shape[1]
    Q = (1.0 / ws.C).reshape(KD)
    EQ = ws.Ew * Q[None, :]
    return ws.A - EQ @ ws.Ew.T, ws.b - EQ @ ws.w.reshape(KD)


def damped_solve(S, v, pose_active, lm: float, ep: float) -> torch.Tensor:
    """Damped Cholesky solve with identity rows for inactive poses
    (SparseBlock::solve, droid_kernels.cu:1248-1269).  A failed
    factorization gives a zero step (chol.py:8-18): ``cholesky_ex`` reports
    it in ``info`` instead of raising, and the step is zeroed by a
    ``where`` on the device, with no host sync."""
    P6 = S.shape[0]
    pa6 = pose_active[:, None].expand(-1, 6).reshape(-1)
    S = S + torch.diag(ep + lm * torch.diagonal(S))
    S = torch.where(pa6[:, None] & pa6[None, :], S, torch.zeros((), dtype=S.dtype, device=S.device))
    S = S + torch.diag((~pa6).to(S.dtype))
    v = torch.where(pa6, v, torch.zeros_like(v))
    L, info = torch.linalg.cholesky_ex(S)
    dx = torch.cholesky_solve(v[:, None], L)[:, 0]
    bad = (info != 0) | torch.any(torch.isnan(dx))
    return torch.where(bad, torch.zeros_like(dx), dx)


def back_substitute_depth(ws: WindowSystem, dx, nfixed) -> torch.Tensor:
    """dz = Q (w - E^T dx), skipping pose slot nfixed (EvT ix <= 0 guard,
    droid_kernels.cu:1152-1153)."""
    KD = ws.Ew.shape[1]
    P = ws.C.shape[0]
    slot = torch.arange(P, device=dx.device)
    dx_masked = torch.where((slot == nfixed).repeat_interleave(6), torch.zeros_like(dx), dx)
    Etdx = dx_masked[None, :] @ ws.Ew
    Q = (1.0 / ws.C).reshape(KD)
    return (Q * (ws.w.reshape(KD) - Etdx[0])).reshape(ws.C.shape)


def retract(poses, disps, dx, dz, pose_active, depth_active=None):
    """SE3 retraction of the poses, additive update of the disparities."""
    P = poses.shape[0]
    dx = dx.reshape(P, 6)
    poses = torch.where(pose_active[:, None], lie.se3_retr(poses, dx), poses)
    if depth_active is None:
        depth_active = torch.ones((P,), dtype=torch.bool, device=poses.device)
    dz = torch.where(depth_active[:, None], dz.reshape(P, -1), torch.zeros_like(dz.reshape(P, -1)))
    return poses, disps + dz.reshape(disps.shape)


class PairwiseSystem(NamedTuple):
    S: torch.Tensor
    v: torch.Tensor
    C: torch.Tensor
    w: torch.Tensor
    pose_active: torch.Tensor
    A: torch.Tensor
    b: torch.Tensor


def _placement_matrix(li, lj, P: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(P*6, E*12) one-hot: column e*12+k -> pose row role_{k//6}(e)*6 + k%6."""
    E = li.shape[0]
    dev = li.device
    k = torch.arange(12, device=dev)
    role = torch.where(k[None, :] < 6, li[:, None], lj[:, None]).reshape(E * 12)
    kk = (k % 6).repeat(E)
    row = torch.arange(P * 6, device=dev)
    M = (role[None, :] == (row[:, None] // 6)) & (kk[None, :] == (row[:, None] % 6))
    return M.to(dtype)


def _block_diag(H: torch.Tensor) -> torch.Tensor:
    """(E, 12, 12) per-edge blocks -> the (E*12, E*12) block diagonal."""
    E = H.shape[0]
    eye = torch.eye(E, dtype=H.dtype, device=H.device)
    return (H[:, :, None, :] * eye[:, None, :, None]).reshape(E * 12, E * 12)


def _accumulate_depth_diag(sys_e: EdgeSystem, ki: torch.Tensor, P: int):
    """The depth diagonal ``C`` and right-hand side ``w`` of these edges,
    summed onto their source frames ``ki`` (P, D)."""
    Ok = (torch.arange(P, device=ki.device)[:, None] == ki[None, :]).to(sys_e.C.dtype)
    return Ok @ sys_e.C, Ok @ sys_e.w


def _couplings(sys_e: EdgeSystem, li: torch.Tensor, lj: torch.Tensor) -> torch.Tensor:
    """(E, 12, D) pose-depth couplings, zero at fixed or outside poses."""
    Ei = sys_e.Ei * (li >= 0)[:, None, None]
    Ej = sys_e.Ej * (lj >= 0)[:, None, None]
    return torch.cat([Ei, Ej], dim=1)


def _pair_product(Exy: torch.Tensor, Q: torch.Tensor, ki: torch.Tensor,
                  ii: torch.Tensor) -> torch.Tensor:
    """``T = (Exy Q[ii]) Exy^T`` over depth pixels, (E*12, E*12), masked to
    the edge pairs that share a source frame."""
    E, _, D = Exy.shape
    ExyQ = Exy * Q[ki][:, None, :]
    T = (ExyQ.reshape(E * 12, D) @ Exy.reshape(E * 12, D).T).reshape(E, 12, E, 12)
    pair = (ii[:, None] == ii[None, :]).to(T.dtype)
    return (T * pair[:, None, :, None]).reshape(E * 12, E * 12)


def assemble_pairwise(sys_e: EdgeSystem, ii, jj, P: int, nfixed, nactive, eta,
                      disps=None, disps_sens=None, alpha: float = 0.05,
                      group=None) -> PairwiseSystem:
    """A, b, C, w and the Schur complement without the dense coupling:
    ``T = (Exy Q[ii]) Exy^T`` over depth pixels, masked to edge pairs that
    share a source frame, placed with one one-hot matrix:
    ``S = M (Hbd - T) M^T``.

    With a process ``group`` the edges are this rank's share (equal sizes
    on every rank): the depth diagonal (C, w) is summed over the ranks, and
    the per-edge blocks ``H``, ``v`` and couplings ``Exy`` are gathered with
    their indices, so every rank forms the pose system and ``S`` from every
    edge in one process's order and by its formula
    (``parallel/shard_ba.py``)."""
    dev = ii.device
    li, lj = _edge_pose_indices(ii, jj, nfixed, nactive)
    slot = torch.arange(P, device=dev)
    depth_active = slot < nactive
    C, w = _accumulate_depth_diag(sys_e, torch.clamp(ii, 0, P - 1), P)
    H, v, Exy = sys_e.H, sys_e.v, _couplings(sys_e, li, lj)
    if group is not None:
        C, w = col.all_sum_packed((C, w), group)
        packed = col.all_cat(torch.cat([H, v[:, :, None], Exy], dim=2), group)
        H, v, Exy = packed[:, :, :12], packed[:, :, 12], packed[:, :, 13:]
        ii, li, lj = col.all_cat_packed((ii, li, lj), group)
    C, w = _finish_depth_diag(C, w, eta, depth_active, disps, disps_sens, alpha)
    Q = 1.0 / C

    ki = torch.clamp(ii, 0, P - 1)
    M = _placement_matrix(li, lj, P, H.dtype)
    T = _pair_product(Exy, Q, ki, ii)
    Hbd = _block_diag(H)
    S = (M @ (Hbd - T)) @ M.T
    A, b = (M @ Hbd) @ M.T, M @ v.reshape(-1)
    Ev = torch.einsum("ecd,ed->ec", Exy, (Q * w)[ki])
    EQw = M @ Ev.reshape(-1)

    pose_active = (slot >= nfixed) & (slot < nactive)
    pa6 = pose_active[:, None].expand(-1, 6).reshape(-1)
    zero = torch.zeros((), dtype=b.dtype, device=dev)
    return PairwiseSystem(S=S, v=torch.where(pa6, b - EQw, zero), C=C, w=w,
                          pose_active=pose_active, A=A, b=torch.where(pa6, b, zero))


def _depth_accumulate(sys_e: EdgeSystem, ii, jj, dx, nfixed, nactive, P: int) -> torch.Tensor:
    """``E^T dx`` summed onto the source frames (P, D), the step of pose
    slot ``nfixed`` left out (droid_kernels.cu:1152-1153)."""
    dev = ii.device
    dxm = dx.reshape(P, 6)
    dxm = torch.where((torch.arange(P, device=dev) == nfixed)[:, None], torch.zeros_like(dxm), dxm)
    li, lj = _edge_pose_indices(ii, jj, nfixed, nactive)
    dxi = torch.where((li >= 0)[:, None], dxm[torch.clamp(li, 0, P - 1)], torch.zeros((), device=dev))
    dxj = torch.where((lj >= 0)[:, None], dxm[torch.clamp(lj, 0, P - 1)], torch.zeros((), device=dev))
    dw = torch.einsum("ecd,ec->ed", sys_e.Ei, dxi) + torch.einsum("ecd,ec->ed", sys_e.Ej, dxj)
    ki = torch.clamp(ii, 0, P - 1)
    Ok = (torch.arange(P, device=dev)[:, None] == ki[None, :]).to(dw.dtype)
    return Ok @ dw


def back_substitute_pairwise(ps: PairwiseSystem, sys_e: EdgeSystem, ii, jj, dx, nfixed, nactive,
                             group=None):
    """dz = Q (w - E^T dx) edge-wise, with the pose-t0 exclusion; with a
    process ``group``, ``E^T dx`` of this rank's edges summed over the
    ranks."""
    P = ps.C.shape[0]
    acc = _depth_accumulate(sys_e, ii, jj, dx, nfixed, nactive, P)
    if group is not None:
        acc = col.all_sum(acc, group)
    return (1.0 / ps.C) * (ps.w - acc)


class BAState(NamedTuple):
    poses: torch.Tensor  # (P, 7)
    disps: torch.Tensor  # (P, H, W)


def ba(poses, disps, intrinsics, targets, weights, eta, ii, jj, edge_mask, nfixed, nactive,
       disps_sens=None, iterations: int = 2, lm: float = 1e-4, ep: float = 0.1,
       alpha: float = 0.05, motion_only: bool = False, use_sens: bool = False,
       schur: str = "pairwise", group=None) -> BAState:
    """``iterations`` Gauss-Newton steps on a window (droid_kernels.cu:1394-1512).
    ``nfixed``/``nactive`` may be ints or 0-d tensors.  With a process
    ``group`` (the pairwise route only) the edge arguments are this rank's
    share, the window state is replicated and so is the result
    (:func:`assemble_pairwise`)."""
    if group is not None and (schur != "pairwise" or motion_only):
        raise ValueError("an edge-sharded dba.ba takes the pairwise route only")
    P = poses.shape[0]
    p, d = poses, disps
    for _ in range(iterations):
        es = build_edge_system(p, d, intrinsics, targets, weights, ii, jj, edge_mask)
        if schur == "pairwise" and not motion_only:
            ps = assemble_pairwise(es, ii, jj, P, nfixed, nactive, eta,
                                   disps=d if use_sens else None,
                                   disps_sens=disps_sens if use_sens else None, alpha=alpha,
                                   group=group)
            dx = damped_solve(ps.S, ps.v, ps.pose_active, lm, ep)
            dz = back_substitute_pairwise(ps, es, ii, jj, dx, nfixed, nactive, group)
            pose_active = ps.pose_active
        else:
            ws = assemble_window_system(es, ii, jj, P, nfixed, nactive, eta,
                                        disps=d if use_sens else None,
                                        disps_sens=disps_sens if use_sens else None, alpha=alpha)
            pose_active = ws.pose_active
            if motion_only:
                dx = damped_solve(ws.A, ws.b, ws.pose_active, lm, ep)
                dz = torch.zeros_like(ws.C)
            else:
                S, v_r = reduced_camera_system(ws)
                dx = damped_solve(S, v_r, ws.pose_active, lm, ep)
                dz = back_substitute_depth(ws, dx, nfixed)
        depth_active = torch.arange(P, device=poses.device) < nactive
        p, d = retract(p, d, dx, dz, pose_active, depth_active)
    return BAState(p, torch.clamp(d, min=0.001))


# ---------------------------------------------------------------------------
# multi-sensor coupling surface (BACore, droid_kernels.cu:1786-1956)
# ---------------------------------------------------------------------------

def window_rows(buf: torch.Tensor, s0: Union[int, torch.Tensor], P: int) -> torch.Tensor:
    """Rows ``[s0, s0 + P)`` of a keyframe buffer; slots past its end read
    the last row and only ever serve as inactive padding.

    Where ``s0 + P`` fits the buffer this is the slice the JAX package takes
    with ``jax.lax.dynamic_slice``.  Past the end that call moves the start
    down to ``B - P`` instead, so its slots stop meaning frames ``s0 + l``
    and the coupled solve reads the wrong poses; the port pads instead.
    ``s0`` may be a 0-d device tensor (the asynchronous step's window
    origin): then the rows are one gather, with no host read.
    """
    B = buf.shape[0]
    if isinstance(s0, int) and s0 + P <= B:
        return buf[s0:s0 + P]
    idx = torch.clamp(torch.arange(P, device=buf.device) + s0, max=B - 1)
    return buf[idx]


def write_window_rows(buf: torch.Tensor, rows: torch.Tensor, s0: Union[int, torch.Tensor]) -> None:
    """Write a window back in place, dropping its padding slots.  With a
    tensor ``s0``, every buffer row is selected from the window or kept
    (one gather, no host read)."""
    if isinstance(s0, int):
        n = min(rows.shape[0], buf.shape[0] - s0)
        buf[s0:s0 + n] = rows[:n]
        return
    P = rows.shape[0]
    slot = torch.arange(buf.shape[0], device=buf.device) - s0
    inside = ((slot >= 0) & (slot < P)).reshape((-1,) + (1,) * (buf.dim() - 1))
    buf.copy_(torch.where(inside, rows[torch.clamp(slot, 0, P - 1)], buf))


def coupled_hessian(poses_w, disps_w, intrinsics, targets, weights, eta, ii_w, jj_w, mask,
                    nactive, disps_sens=None, use_sens: bool = False, alpha: float = 0.001):
    """Undamped reduced camera system over the window (BACore::hessian):
    every slot below ``nactive`` is a free pose (the factor graph anchors the
    gauge); alpha is BACore's 0.001 (droid_kernels.cu:1873)."""
    P = poses_w.shape[0]
    es = build_edge_system(poses_w, disps_w, intrinsics, targets, weights, ii_w, jj_w, mask)
    ps = assemble_pairwise(es, ii_w, jj_w, P, 0, nactive, eta,
                           disps=disps_w if use_sens else None,
                           disps_sens=disps_sens if use_sens else None, alpha=alpha)
    return ps.S, ps.v


def coupled_retract(poses_w, disps_w, intrinsics, targets, weights, eta, ii_w, jj_w, mask,
                    nactive, dx):
    """Apply an externally solved (P, 6) pose step and the depth update it
    induces (BACore::retract, droid_kernels.cu:1918-1956), relinearizing at
    the current state instead of caching E/Q/w."""
    P = poses_w.shape[0]
    es = build_edge_system(poses_w, disps_w, intrinsics, targets, weights, ii_w, jj_w, mask)
    ps = assemble_pairwise(es, ii_w, jj_w, P, 0, nactive, eta)
    dz = back_substitute_pairwise(ps, es, ii_w, jj_w, dx, 0, nactive)
    depth_active = torch.arange(P, device=poses_w.device) < nactive
    poses_w, disps_w = retract(poses_w, disps_w, dx, dz, ps.pose_active, depth_active)
    return poses_w, torch.clamp(disps_w, min=0.001)


def _window_eta(damping_buf, s0, P: int, eps_damping: float):
    return 0.2 * window_rows(damping_buf, s0, P).reshape(P, -1) + eps_damping


def coupled_hessian_full(poses_buf, disps_buf, damping_buf, intrinsics, targets, weights,
                         ii_w, jj_w, mask, s0, nactive, P: int, eps_damping: float = 1e-7):
    """BACore::hessian on the window ``[s0, s0 + P)`` of the full buffers
    (``s0`` and ``nactive`` ints or 0-d device tensors)."""
    return coupled_hessian(window_rows(poses_buf, s0, P), window_rows(disps_buf, s0, P),
                           intrinsics, targets, weights,
                           _window_eta(damping_buf, s0, P, eps_damping), ii_w, jj_w, mask, nactive)


def coupled_retract_full(poses_buf, disps_buf, damping_buf, intrinsics, targets, weights,
                         ii_w, jj_w, mask, s0, nactive, dx, P: int,
                         eps_damping: float = 1e-7, with_hessian: bool = False):
    """BACore::retract on the full buffers, written back in place; with
    ``with_hessian`` also the reduced camera system of the retracted state
    (the coupled loop alternates retract and hessian).  Returns
    (poses_buf, disps_buf, S or None, v or None)."""
    eta = _window_eta(damping_buf, s0, P, eps_damping)
    poses_w, disps_w = coupled_retract(window_rows(poses_buf, s0, P),
                                       window_rows(disps_buf, s0, P), intrinsics, targets,
                                       weights, eta, ii_w, jj_w, mask, nactive, dx)
    write_window_rows(poses_buf, poses_w, s0)
    write_window_rows(disps_buf, disps_w, s0)
    if not with_hessian:
        return poses_buf, disps_buf, None, None
    S, v = coupled_hessian(poses_w, disps_w, intrinsics, targets, weights, eta, ii_w, jj_w, mask,
                           nactive)
    return poses_buf, disps_buf, S, v
