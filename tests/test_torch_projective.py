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


def _export_scene(seed, N=9, H=12, W=16):
    """Keyframes along a short path looking at one slanted plane, so the
    neighbours see each other's pixels and the vote has work to do."""
    rng = np.random.default_rng(seed)
    xi = np.zeros((N, 6), np.float32)
    xi[:, 0] = 0.05 * np.arange(N) + 0.01 * rng.normal(size=N)
    xi[:, 3:] = 0.01 * rng.normal(size=(N, 3))
    poses = np.asarray(jl.se3_exp(jnp.asarray(xi)))
    v = np.arange(H, dtype=np.float32)[:, None]
    disps = np.broadcast_to(0.4 + 0.01 * v, (N, H, W)).astype(np.float32)
    disps = disps * (1.0 + 0.02 * rng.normal(size=(N, H, W))).astype(np.float32)
    intr = np.asarray([14.0, 14.0, W / 2, H / 2], np.float32)
    return poses, disps, intr


def test_iproj_points():
    """f32 round-off: within 1e-5 of the largest |point|."""
    poses, disps, intr = _export_scene(4)
    Twc = np.asarray(jl.se3_inv(jnp.asarray(poses)))
    j, t = _both("iproj_points", Twc, disps, intr)
    j = np.asarray(j)
    assert t.shape == j.shape == disps.shape + (3,)
    np.testing.assert_allclose(t.numpy(), j, atol=1e-5 * np.abs(j).max())


def _vote_margins(poses, disps, intr, ix, thresh):
    """Per (queried frame, pixel): the smallest |(|1/d_proj - 1/d_tap|) -
    thresh| over the neighbours and taps, from the JAX package's
    reprojection (where f32 round-off in another order can flip a vote)."""
    offs = np.asarray([-1, -2, -3, 3, 4, 5])
    nb = np.clip(ix[:, None] + offs[None], 0, len(disps) - 1)
    K, J = nb.shape
    H, W = disps.shape[1:]
    c, _ = jp.projective_transform(jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr),
                                   jnp.asarray(np.repeat(ix, J)), jnp.asarray(nb.reshape(-1)),
                                   return_depth=True)
    c = np.asarray(c).reshape(K, J, H, W, 3)
    u0 = np.clip(np.floor(c[..., 0]), 0, W - 2).astype(int)
    v0 = np.clip(np.floor(c[..., 1]), 0, H - 2).astype(int)
    inv_dj = 1.0 / np.maximum(c[..., 2], 1e-8)
    margin = np.full((K, H, W), np.inf)
    for dv in (0, 1):
        for du in (0, 1):
            tap = disps[nb[:, :, None, None], v0 + dv, u0 + du]
            m = np.abs(np.abs(inv_dj - 1.0 / np.maximum(tap, 1e-8))
                       - thresh[:, None, None, None])
            margin = np.minimum(margin, m.min(1))
    return margin


def test_depth_consistency_count():
    """Equal counts, except at pixels where some tap lies within 1e-5 of
    the threshold (the two packages' f32 reprojections may vote apart
    there)."""
    poses, disps, intr = _export_scene(5)
    ix = np.arange(len(disps))
    thresh = np.linspace(0.05, 0.4, len(ix)).astype(np.float32)
    j, t = _both("depth_consistency_count", poses, disps, intr, ix, thresh)
    j = np.asarray(j)
    assert t.dtype == torch.float32 and t.shape == j.shape
    clear = _vote_margins(poses, disps, intr, ix, thresh) >= 1e-5
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(t.numpy()[clear], j[clear])
    assert 0 < j.mean() < 6  # some votes pass and some fail


def test_depth_consistency_count_selfconsistent():
    """test_projective.py::test_depth_consistency_count_selfconsistent:
    identical poses and disparities -> an interior pixel agrees with all
    six neighbours."""
    ht, wd, n = 12, 16, 10
    from dbaf_tpu_torch.ops import lie as tl

    poses = tl.se3_identity((n,))
    disps = torch.full((n, ht, wd), 0.7)
    intr = torch.tensor([24.0, 24.0, wd / 2, ht / 2])
    count = tp.depth_consistency_count(poses, disps, intr, torch.tensor([4]), torch.tensor([0.1]))
    assert count[0, 5, 8] == 6.0


def test_projective_transform_comp():
    """The motion-compensated reprojection against the JAX function
    (f32: reprojected pixels to 1e-4); a zero offset gives
    projective_transform's output."""
    poses, disps, intr, ii, jj = _scene(5)
    comp = 0.05 * np.random.default_rng(5).normal(size=(len(ii),) + disps.shape[1:] + (4,))
    comp = comp.astype(np.float32)
    (jc, jv), (tc, tv) = _both("projective_transform_comp", poses, disps, intr, ii, jj, comp)
    np.testing.assert_allclose(np.asarray(jc), tc.numpy(), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    c0, v0 = tp.projective_transform_comp(*(torch.tensor(a) for a in (poses, disps, intr, ii, jj)),
                                          torch.zeros(comp.shape))
    c, v = tp.projective_transform(*(torch.tensor(a) for a in (poses, disps, intr, ii, jj)))
    np.testing.assert_array_equal(c0.numpy(), c.numpy())
    np.testing.assert_array_equal(v0.numpy(), v.numpy())


def test_induced_flow():
    """Against the JAX function (1e-4 px), and zero for identical poses
    (tests/test_projective.py:122, atol 1e-4)."""
    poses, disps, intr, ii, jj = _scene(6)
    (jf, jv), (tf, tv) = _both("induced_flow", poses, disps, intr, ii, jj)
    np.testing.assert_allclose(np.asarray(jf), tf.numpy(), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    ident = tp.lie.se3_identity((5,))
    flow, _ = tp.induced_flow(ident, torch.tensor(disps), torch.tensor(intr),
                              torch.tensor([0]), torch.tensor([1]))
    np.testing.assert_allclose(flow.numpy(), 0.0, atol=1e-4)


def test_stereo_edge_uses_baseline():
    """tests/test_projective.py:95 through the port: an (i, i) edge
    reprojects by the fixed stereo baseline pose (1e-5), as the JAX one."""
    poses, disps, intr, _, _ = _scene(7)
    one = torch.tensor([1])
    coords, _ = tp.projective_transform(torch.tensor(poses), torch.tensor(disps),
                                        torch.tensor(intr), one, one)
    X0 = tp.iproj(torch.tensor(disps[1:2]), torch.tensor(intr).expand(1, 4))
    X1 = tp.lie.se3_act4(torch.tensor(tp._STEREO_POSE)[None, None, None], X0)
    ref = tp.proj(X1, torch.tensor(intr).expand(1, 4))
    np.testing.assert_allclose(coords.numpy(), ref.numpy(), atol=1e-5)
    jc, _ = jp.projective_transform(jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr),
                                    jnp.asarray([1]), jnp.asarray([1]))
    np.testing.assert_allclose(coords.numpy(), np.asarray(jc), atol=1e-4)
