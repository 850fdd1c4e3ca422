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
