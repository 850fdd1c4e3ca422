"""SE(3)/SO(3) operations on quaternion-parameterized poses (PyTorch).

Port of ``dbaf_tpu/ops/lie.py``.  Poses are 7-vectors
``[tx, ty, tz, qx, qy, qz, qw]`` (the lietorch layout), twists are
``[tau, phi]``.  Every function broadcasts over leading dimensions and keeps
the reference's Taylor guards (``torch.where`` with sanitized operands, so
no branch depends on the data).
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_mul(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Hamilton product q ⊗ p for xyzw quaternions."""
    qx, qy, qz, qw = q.unbind(-1)
    px, py, pz, pw = p.unbind(-1)
    return torch.stack(
        [
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py + qy * pw + qz * px - qx * pz,
            qw * pz + qz * pw + qx * py - qy * px,
            qw * pw - qx * px - qy * py - qz * pz,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_act(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vector(s) v by unit quaternion(s) q (two-cross-product form,
    droid_kernels.cu:61-72)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    uv = 2.0 * _cross(qv, v)
    return v + qw * uv + _cross(qv, uv)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def se3_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    ident = torch.tensor([0, 0, 0, 0, 0, 0, 1], dtype=dtype, device=device)
    return ident.expand(tuple(shape) + (7,)).clone()


def se3_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose a ∘ b (apply b first)."""
    q = quat_mul(a[..., 3:], b[..., 3:])
    t = a[..., :3] + quat_act(a[..., 3:], b[..., :3])
    return _cat_tq(t, q)


def _cat_tq(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Concatenate translation and quaternion parts with broadcast leading
    dimensions."""
    lead = torch.broadcast_shapes(t.shape[:-1], q.shape[:-1])
    return torch.cat([t.expand(lead + (3,)), q.expand(lead + (4,))], dim=-1)


def se3_inv(g: torch.Tensor) -> torch.Tensor:
    qinv = quat_conj(g[..., 3:])
    t = -quat_act(qinv, g[..., :3])
    return torch.cat([t, qinv], dim=-1)


def se3_rel(gi: torch.Tensor, gj: torch.Tensor) -> torch.Tensor:
    """Relative transform G_ij = G_j ∘ G_i^{-1} (droid_kernels.cu:101-113)."""
    qij = quat_mul(gj[..., 3:], quat_conj(gi[..., 3:]))
    tij = gj[..., :3] - quat_act(qij, gi[..., :3])
    return torch.cat([tij, qij], dim=-1)


def se3_act(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return quat_act(g[..., 3:], x) + g[..., :3]


def se3_act4(g: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Apply SE3 to homogeneous-depth points ``(x, y, z, d)``:
    ``Y[:3] = R X[:3] + d t``, ``Y[3] = d`` (droid_kernels.cu:75-83)."""
    d = X[..., 3:4]
    y = quat_act(g[..., 3:], X[..., :3]) + d * g[..., :3]
    return torch.cat([y, d], dim=-1)


def se3_adjT(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Dual adjoint ``Ad_g^T a`` for twists ``a = [v, w]``:
    ``[R^T v, R^T (w - t x v)]`` (droid_kernels.cu:86-99)."""
    qinv = quat_conj(g[..., 3:])
    v = a[..., :3]
    w = a[..., 3:]
    t = g[..., :3]
    top = quat_act(qinv, v)
    bot = quat_act(qinv, w - _cross(t, v))
    return torch.cat([top, bot], dim=-1)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> xyzw quaternion (droid_kernels.cu:116-137 guards)."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta_p4 = theta_sq * theta_sq
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS))
    small = theta_sq < 1e-8
    imag_taylor = 0.5 - (1.0 / 48.0) * theta_sq + (1.0 / 3840.0) * theta_p4
    real_taylor = 1.0 - (1.0 / 8.0) * theta_sq + (1.0 / 384.0) * theta_p4
    imag_exact = torch.sin(0.5 * theta) / theta
    real_exact = torch.cos(0.5 * theta)
    imag = torch.where(small, imag_taylor, imag_exact)
    real = torch.where(small, real_taylor, real_exact)
    return torch.cat([imag * phi, real], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    qv = q[..., :3]
    qw = q[..., 3:4]
    sign = torch.where(qw < 0, -1.0, 1.0).to(q.dtype)
    qv = qv * sign
    qw = qw * sign
    norm_v = torch.linalg.norm(qv, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(norm_v, qw)
    small = norm_v < 1e-8
    scale = torch.where(
        small, 2.0 / torch.clamp(qw, min=1e-8), theta / torch.clamp(norm_v, min=_EPS)
    )
    return scale * qv


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist [tau, phi] -> pose, closed-form left Jacobian with the
    reference's theta > 1e-4 cutoff (droid_kernels.cu:155-184)."""
    tau = xi[..., :3]
    phi = xi[..., 3:]
    q = so3_exp(phi)
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS))
    use_exact = theta > 1e-4
    zero = torch.zeros_like(theta)
    a = torch.where(use_exact, (1.0 - torch.cos(theta)) / torch.clamp(theta_sq, min=_EPS), zero)
    b = torch.where(
        use_exact, (theta - torch.sin(theta)) / torch.clamp(theta * theta_sq, min=_EPS), zero
    )
    c1 = _cross(phi, tau)
    c2 = _cross(phi, c1)
    t = tau + a * c1 + b * c2
    return torch.cat([t, q], dim=-1)


def se3_log(g: torch.Tensor) -> torch.Tensor:
    q = g[..., 3:]
    t = g[..., :3]
    phi = so3_log(q)
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS))
    half = 0.5 * theta
    cot = torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS)
    coef_exact = (1.0 - half * cot) / torch.clamp(theta_sq, min=_EPS)
    coef_taylor = 1.0 / 12.0 + theta_sq / 720.0
    coef = torch.where(theta > 1e-4, coef_exact, coef_taylor)
    c1 = _cross(phi, t)
    c2 = _cross(phi, c1)
    tau = t - 0.5 * c1 + coef * c2
    return torch.cat([tau, phi], dim=-1)


def se3_retr(g: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Retraction ``exp(xi) ∘ g`` (droid_kernels.cu:922-940)."""
    return se3_mul(se3_exp(xi), g)


def se3_normalize(g: torch.Tensor) -> torch.Tensor:
    q = g[..., 3:]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.cat([g[..., :3], q], dim=-1)


def se3_matrix(g: torch.Tensor) -> torch.Tensor:
    """7-vector -> 4x4 homogeneous matrix."""
    R = quat_to_matrix(g[..., 3:])
    t = g[..., :3]
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=g.dtype, device=g.device)
    bottom = bottom.expand(g.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], dim=-2)
