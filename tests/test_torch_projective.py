"""Port parity: dbaf_tpu_torch.ops.projective against dbaf_tpu.ops.projective
(f32, CPU, same numpy inputs; tolerance is f32 round-off)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbaf_tpu.ops import lie as jl
from dbaf_tpu.ops import projective as jp
from dbaf_tpu_torch.ops import projective as tp


def _scene(seed, N=5, H=6, W=8):
    rng = np.random.default_rng(seed)
    xi = np.concatenate([0.2 * rng.normal(size=(N, 3)), 0.05 * rng.normal(size=(N, 3))], -1)
    poses = np.asarray(jl.se3_exp(jnp.asarray(xi, jnp.float32)))
    disps = (0.3 + rng.random((N, H, W))).astype(np.float32)
    intr = np.asarray([12.0, 11.0, W / 2, H / 2], np.float32)
    ii = np.asarray([0, 1, 2, 3, 4, 2, 1], np.int64)
    jj = np.asarray([1, 0, 4, 2, 3, 2, 3], np.int64)  # incl. a stereo (ii==jj) edge
    return poses, disps, intr, ii, jj


def _both(fn_name, *args, **kw):
    ja = [jnp.asarray(a) for a in args]
    ta = [torch.tensor(a) for a in args]
    return getattr(jp, fn_name)(*ja, **kw), getattr(tp, fn_name)(*ta, **kw)


def test_iproj_proj_grid():
    poses, disps, intr, ii, jj = _scene(0)
    np.testing.assert_array_equal(np.asarray(jp.coords_grid(3, 4)), tp.coords_grid(3, 4).numpy())
    j, t = _both("iproj", disps, np.broadcast_to(intr, (5, 4)).copy())
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=1e-6)
    j2, t2 = jp.proj(j, jnp.asarray(intr)), tp.proj(t, torch.tensor(intr))
    np.testing.assert_allclose(np.asarray(j2), t2.numpy(), atol=1e-5)


@pytest.mark.parametrize("per_frame_intr", [False, True])
def test_projective_transform(per_frame_intr):
    poses, disps, intr, ii, jj = _scene(1)
    if per_frame_intr:
        intr = np.broadcast_to(intr, (5, 4)).copy()
    (jc, jv), (tc, tv) = _both("projective_transform", poses, disps, intr, ii, jj)
    np.testing.assert_allclose(np.asarray(jc), tc.numpy(), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


def test_projection_jacobians():
    poses, disps, intr, ii, jj = _scene(2)
    j, t = _both("projection_jacobians", poses, disps, intr, ii, jj)
    for name in ("coords", "Ji", "Jj", "Jz"):
        np.testing.assert_allclose(np.asarray(getattr(j, name)), getattr(t, name).numpy(),
                                   atol=1e-4, rtol=1e-5, err_msg=name)
    np.testing.assert_array_equal(np.asarray(j.valid), t.valid.numpy())


@pytest.mark.parametrize("fn", ["frame_distance", "frame_distance_bidirectional"])
def test_frame_distance(fn):
    poses, disps, intr, ii, jj = _scene(3)
    keep = ii != jj
    j, t = _both(fn, poses, disps, intr, ii[keep], jj[keep], beta=0.3)
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=1e-5, atol=1e-5)
