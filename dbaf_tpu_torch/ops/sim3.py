"""Sim(3) group on 8-vectors ``(tx, ty, tz, qx, qy, qz, qw, s)`` (PyTorch).

Port of ``dbaf_tpu/ops/sim3.py``: the training-time Sim3 surface (the
7-dof branch of ``projective_transform``, projective_ops.py:84-94, and the
Sim3 pose metrics of the losses, geom/losses.py:9-27).  Same memory layout
as lietorch (data split [3, 4, 1]); tangent vectors are
``[tau(3), phi(3), sigma(1)]``.  Every function broadcasts over leading
dimensions and keeps the Taylor guards as ``torch.where`` on sanitized
operands, so no branch depends on the data.
"""

from __future__ import annotations

import torch

from . import lie

_EPS = 1e-12


def identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    g = torch.zeros(tuple(shape) + (8,), dtype=dtype, device=device)
    g[..., 6] = 1.0
    g[..., 7] = 1.0
    return g


def from_se3(g7: torch.Tensor) -> torch.Tensor:
    """Lift SE3 7-vectors to Sim3 with unit scale (lietorch ``Sim3(SE3)``)."""
    return torch.cat([g7, torch.ones_like(g7[..., :1])], dim=-1)


def to_se3(g: torch.Tensor) -> torch.Tensor:
    """Drop the scale entry (the caller holds s == 1)."""
    return g[..., :7]


def _cat(*parts: torch.Tensor) -> torch.Tensor:
    lead = torch.broadcast_shapes(*(p.shape[:-1] for p in parts))
    return torch.cat([p.expand(lead + p.shape[-1:]) for p in parts], dim=-1)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(t1,R1,s1)·(t2,R2,s2) = (t1 + s1 R1 t2, R1 R2, s1 s2)."""
    t = a[..., :3] + a[..., 7:8] * lie.quat_act(a[..., 3:7], b[..., :3])
    q = lie.quat_mul(a[..., 3:7], b[..., 3:7])
    s = a[..., 7:8] * b[..., 7:8]
    return _cat(t, q, s)


def inv(g: torch.Tensor) -> torch.Tensor:
    qc = lie.quat_conj(g[..., 3:7])
    s_inv = 1.0 / g[..., 7:8]
    t = -s_inv * lie.quat_act(qc, g[..., :3])
    return torch.cat([t, qc, s_inv], dim=-1)


def rel(gi: torch.Tensor, gj: torch.Tensor) -> torch.Tensor:
    """G_ij = gj · gi^-1 (the convention of ``lie.se3_rel``)."""
    return mul(gj, inv(gi))


def act(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Point action s R x + t."""
    return g[..., 7:8] * lie.quat_act(g[..., 3:7], x) + g[..., :3]


def act4(g: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Homogeneous-depth action (p, d) -> (s R p + d t, d), lietorch
    ``Sim3.act4`` (projective_ops.py:69-90)."""
    p = X[..., :3]
    d = X[..., 3:4]
    p1 = g[..., 7:8] * lie.quat_act(g[..., 3:7], p) + d * g[..., :3]
    return _cat(p1, d)


def scale(g: torch.Tensor, s) -> torch.Tensor:
    """Scale the translation (lietorch ``.scale``, used by fit_scale)."""
    s = torch.as_tensor(s, dtype=g.dtype, device=g.device)
    if s.dim() == g.dim() - 1:
        s = s[..., None]
    return _cat(g[..., :3] * s, g[..., 3:])


def _calc_W_coeffs(theta_sq, sigma):
    """(A, B, C) of W = C I + A Phi + B Phi^2 with
    W = ∫_0^1 e^{sigma u} R(u phi) du (Strasdat's Sim3 exp, Sophus calcW).
    All inputs (..., 1)."""
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS))
    es = torch.exp(sigma)
    small_t = theta_sq < 1e-8
    small_s = torch.abs(sigma) < 1e-5

    one = torch.ones_like(sigma)
    sig_safe = torch.where(small_s, one, sigma)
    th_safe = torch.where(small_t, one, theta)
    c = sigma * sigma + theta_sq

    C = torch.where(small_s, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (es - 1.0) / sig_safe)

    a = es * torch.sin(theta)
    b = es * torch.cos(theta)
    c_safe = torch.where(c < _EPS, one, c)

    A_exact = (a * sigma + (1.0 - b) * theta) / (th_safe * c_safe)
    A_sig = (es * (sigma - 1.0) + 1.0) / (sig_safe * sig_safe)
    A_both = 0.5 + sigma / 3.0
    A = torch.where(small_t, torch.where(small_s, A_both, A_sig), A_exact)

    B_exact = (C - ((b - 1.0) * sigma + a * theta) / c_safe) / torch.where(
        small_t, one, theta_sq)
    B_sig = (es * (sigma * sigma - 2.0 * sigma + 2.0) - 2.0) / (2.0 * sig_safe ** 3)
    B_both = 1.0 / 6.0 + sigma / 8.0
    B = torch.where(small_t, torch.where(small_s, B_both, B_sig), B_exact)
    return A, B, C


def _apply_W(tau, phi, theta_sq, sigma, inverse: bool = False):
    """W tau = C tau + A (phi x tau) + B (phi x (phi x tau)); the inverse
    solves the 3 x 3 system."""
    A, B, C = _calc_W_coeffs(theta_sq, sigma)
    if not inverse:
        c1 = lie._cross(phi, tau)
        c2 = lie._cross(phi, c1)
        return C * tau + A * c1 + B * c2
    x, y, z = phi.unbind(-1)
    o = torch.zeros_like(x)
    Phi = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1).reshape(phi.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=tau.dtype, device=tau.device)
    W = C[..., None] * eye + A[..., None] * Phi + B[..., None] * (Phi @ Phi)
    return torch.linalg.solve(W, tau[..., None])[..., 0]


def exp(xi: torch.Tensor) -> torch.Tensor:
    """Sim(3) exponential: [tau, phi, sigma] -> 8-vector."""
    tau, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    q = lie.so3_exp(phi)
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    t = _apply_W(tau, phi, theta_sq, sigma)
    return torch.cat([t, q, torch.exp(sigma)], dim=-1)


def log(g: torch.Tensor) -> torch.Tensor:
    """Sim(3) log: 8-vector -> [tau, phi, sigma]."""
    phi = lie.so3_log(g[..., 3:7])
    sigma = torch.log(g[..., 7:8])
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    tau = _apply_W(g[..., :3], phi, theta_sq, sigma, inverse=True)
    return torch.cat([tau, phi, sigma], dim=-1)


def retr(g: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left retraction exp(xi) · g (the convention of ``lie.se3_retr``)."""
    return mul(exp(xi), g)


def adjT(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Transpose adjoint ``Ad_g^T a`` for 7-tangents ``a = [v, w, l]``:
    ``[s R^T v, R^T (w - t x v), l - t·v]``; the first 6 rows are
    ``lie.se3_adjT`` when s == 1."""
    qinv = lie.quat_conj(g[..., 3:7])
    t = g[..., :3]
    s = g[..., 7:8]
    v, w, lam = a[..., :3], a[..., 3:6], a[..., 6:7]
    top = s * lie.quat_act(qinv, v)
    mid = lie.quat_act(qinv, w - lie._cross(t, v))
    bot = lam - torch.sum(t * v, dim=-1, keepdim=True)
    return _cat(top, mid, bot)
