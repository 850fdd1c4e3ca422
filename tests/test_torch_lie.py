"""Port parity: dbaf_tpu_torch.ops.lie against dbaf_tpu.ops.lie (f32, CPU).

Inputs are made with numpy from a seed and fed to both packages; the
tolerance is f32 round-off of the same formulas in two frameworks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbaf_tpu.ops import lie as jl
from dbaf_tpu_torch.ops import lie as tl

ATOL = 1e-5


def _poses(rng, n):
    xi = np.concatenate([rng.normal(size=(n, 3)), 0.8 * rng.normal(size=(n, 3))], -1)
    return np.asarray(jl.se3_exp(jnp.asarray(xi, jnp.float32)))


def _twists(rng, n):
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    xi[: n // 4, 3:] *= 1e-6   # small-angle Taylor branches
    # (angles near 1e-3 are left out: there (1 - cos t) / t^2 cancels in f32
    # in both packages, and the two cos implementations differ by an ulp)
    xi[n // 4: n // 2, 3:] *= 3e-2
    return xi


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=atol, rtol=1e-5)


@pytest.mark.parametrize("name", ["se3_exp", "so3_exp"])
def test_exp_maps(name):
    rng = np.random.default_rng(1)
    xi = _twists(rng, 64)
    arg = xi if name == "se3_exp" else xi[:, 3:]
    _close(getattr(jl, name)(jnp.asarray(arg)), getattr(tl, name)(torch.tensor(arg)))


@pytest.mark.parametrize("name", ["se3_log", "se3_inv", "se3_normalize", "se3_matrix"])
def test_unary_pose_ops(name):
    rng = np.random.default_rng(2)
    g = _poses(rng, 64)
    _close(getattr(jl, name)(jnp.asarray(g)), getattr(tl, name)(torch.tensor(g)), atol=2e-5)


@pytest.mark.parametrize("name", ["se3_mul", "se3_rel"])
def test_binary_pose_ops(name):
    rng = np.random.default_rng(3)
    a, b = _poses(rng, 32), _poses(rng, 32)
    _close(getattr(jl, name)(jnp.asarray(a), jnp.asarray(b)),
           getattr(tl, name)(torch.tensor(a), torch.tensor(b)))


def test_actions_adjoint_retraction():
    rng = np.random.default_rng(4)
    g = _poses(rng, 16)
    X = rng.normal(size=(16, 5, 4)).astype(np.float32)
    a = rng.normal(size=(16, 5, 6)).astype(np.float32)
    xi = _twists(rng, 16)
    _close(jl.se3_act4(jnp.asarray(g)[:, None], jnp.asarray(X)),
           tl.se3_act4(torch.tensor(g)[:, None], torch.tensor(X)))
    _close(jl.se3_act(jnp.asarray(g)[:, None], jnp.asarray(X[..., :3])),
           tl.se3_act(torch.tensor(g)[:, None], torch.tensor(X[..., :3])))
    _close(jl.se3_adjT(jnp.asarray(g)[:, None], jnp.asarray(a)),
           tl.se3_adjT(torch.tensor(g)[:, None], torch.tensor(a)))
    _close(jl.se3_retr(jnp.asarray(g), jnp.asarray(xi)),
           tl.se3_retr(torch.tensor(g), torch.tensor(xi)))


def test_exp_log_roundtrip():
    xi = _twists(np.random.default_rng(5), 64)
    xi[:, 3:] = np.clip(xi[:, 3:], -1.0, 1.0)
    back = tl.se3_log(tl.se3_exp(torch.tensor(xi))).numpy()
    np.testing.assert_allclose(back, xi, atol=1e-4)


def _rotations(rng, n):
    """Rotation matrices over every Shepperd branch: generic angles, angles
    near pi about each axis (qx, qy or qz largest) and the identity."""
    w = rng.normal(size=(n, 3))
    w *= (rng.uniform(0.0, np.pi, size=(n, 1)) / np.linalg.norm(w, axis=1, keepdims=True))
    w[: n // 4] = np.eye(3)[rng.integers(0, 3, n // 4)] * (np.pi - 1e-2) + \
        1e-2 * rng.normal(size=(n // 4, 3))
    w[-1] = 0.0
    return np.asarray(jl.quat_to_matrix(jl.so3_exp(jnp.asarray(w, jnp.float32))))


def test_matrix_to_quat_and_se3_from_matrix_match_jax():
    """Both are branch-free over the four Shepperd candidates with qw >= 0
    canonical, so the quaternions agree without a sign flip (f32, 1e-5)."""
    rng = np.random.default_rng(6)
    R = _rotations(rng, 64)
    _close(jl.matrix_to_quat(jnp.asarray(R)), tl.matrix_to_quat(torch.tensor(R)))
    T = np.tile(np.eye(4, dtype=np.float32), (64, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.normal(size=(64, 3))
    _close(jl.se3_from_matrix(jnp.asarray(T)), tl.se3_from_matrix(torch.tensor(T)))
    # round trip through the port's se3_matrix
    np.testing.assert_allclose(tl.se3_matrix(tl.se3_from_matrix(torch.tensor(T))).numpy(), T,
                               atol=2e-6)


LIE_NP_NAMES = ["matrix_to_quat", "quat_act", "quat_conj", "quat_mul", "quat_to_matrix",
                "se3_act", "se3_act4", "se3_adjT", "se3_exp", "se3_from_matrix", "se3_identity",
                "se3_inv", "se3_log", "se3_matrix", "se3_mul", "se3_normalize", "se3_rel",
                "se3_retr", "so3_exp", "so3_log"]


def test_lie_np_exports_every_public_function():
    """The port's numpy twin has every public function of the port's
    ops/lie, and the same names as the JAX package's twin."""
    from dbaf_tpu.ops import lie_np as jnp_lie
    from dbaf_tpu_torch.ops import lie_np as tnp_lie

    assert sorted(tnp_lie.__all__) == sorted(jnp_lie.__all__) == LIE_NP_NAMES
    assert all(callable(getattr(tnp_lie, n)) for n in LIE_NP_NAMES)


@pytest.mark.parametrize("name", LIE_NP_NAMES)
def test_lie_np_matches_jax_lie_np(name):
    """The port's numpy host twin (f64) against the JAX package's exec-twin
    of ops/lie.py, to 1e-12 (the same formulas in f64; se3_identity in the
    default f32 of both)."""
    from dbaf_tpu.ops import lie_np as jnp_lie
    from dbaf_tpu_torch.ops import lie_np as tnp_lie

    rng = np.random.default_rng(7)
    g = _poses(rng, 32).astype(np.float64)
    g[:, 3:] /= np.linalg.norm(g[:, 3:], axis=1, keepdims=True)
    R = _rotations(rng, 32).astype(np.float64)
    xi = _twists(rng, 32).astype(np.float64)
    v3, v4 = rng.normal(size=(32, 3)), rng.normal(size=(32, 4))
    q = g[:, 3:]
    args = {"se3_mul": (g, g[::-1]), "se3_inv": (g,), "se3_matrix": (g,),
            "quat_to_matrix": (q,), "matrix_to_quat": (R,),
            "se3_from_matrix": (jnp_lie.se3_matrix(g),), "quat_act": (q, v3),
            "quat_conj": (q,), "quat_mul": (q, q[::-1]), "se3_act": (g, v3),
            "se3_act4": (g, v4), "se3_adjT": (g, xi), "se3_exp": (xi,),
            "se3_identity": ((4, 2),), "se3_log": (g,), "se3_normalize": (g,),
            "se3_rel": (g, g[::-1]), "se3_retr": (g, xi), "so3_exp": (xi[:, 3:],),
            "so3_log": (q,)}[name]
    got = getattr(tnp_lie, name)(*args)
    ref = getattr(jnp_lie, name)(*args)
    assert isinstance(got, np.ndarray)
    assert got.dtype == (np.float32 if name == "se3_identity" else np.float64)
    assert got.shape == np.shape(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
