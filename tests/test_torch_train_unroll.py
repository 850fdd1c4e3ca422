"""The port's unrolled training forward against the JAX package's on the
``_tiny_problem`` of ``tests/test_train.py:30-47`` (4 frames, 6 x 8
features, the +-1 edges), f32 networks on the same weights (the JAX
package's initialization, carried over with ``from_jax_params``),
``num_steps`` 2.

The delta head (``update.delta_2``) is scaled by 0.01.  With the
initialization as it is, the update operator proposes flow deltas of up to
21 px on the 8 px wide grid, the second Gauss-Newton step of each unroll
step is ill-conditioned, and the JAX package's own parameter gradients move
by 6.6% (median over leaves) when the images move by 1e-3 intensity
levels; the port's differ from them by as much.  Scaled, the deltas stay
under a pixel and that spread is 1.1e-4 (median leaf).

The sample is drawn with seed 1.  Seed 0's images put one ReLU input of
``fnet.layer1_0.conv1`` 2.9e-7 from the kink, where the two packages' f32
values fall on either side of it: that one pixel's term moves that leaf's
gradient by 3.7% of its largest entry, while every other leaf agrees to
2.2e-4 (median 6.5e-5).

Held: the pose (atol 1e-5), upsampled-disparity (5e-4) and residual (1e-4)
iterates, the loss of ``tests/test_train.py:75-85`` (rtol 1e-5) and the
gradient of every parameter leaf, each within 1e-3 of the JAX leaf's
largest entry plus 1e-6 of the largest entry of all leaves (the biases of
the convolutions ahead of fnet's instance norms have a zero gradient,
which both packages give as f32 rounding noise of about 1e-7).  The JAX
step is jitted: traced op by op it takes minutes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbaf_tpu.models import DroidNet as JNet
from dbaf_tpu.ops import lie as jlie
from dbaf_tpu.train import losses as jlosses
from dbaf_tpu.train.unroll import forward as jforward
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_train import _tiny_problem

N_FRAMES, H8, W8 = 4, 6, 8
SEED = 1


def jax_params(h8=H8, w8=W8, delta_scale=1.0):
    """tests/test_train.py's initialization of the f32 DroidNet with the
    GraphAgg head, the delta head scaled by ``delta_scale``."""
    model = JNet(dtype=jnp.float32)
    probe = jnp.zeros((1, 8 * h8, 8 * w8, 3), jnp.float32)
    params = jax.jit(lambda k: model.init(k, probe, method=model.extract_features))(
        jax.random.PRNGKey(0))["params"]
    uparams = jax.jit(lambda k: model.init(
        k, jnp.zeros((2, h8, w8, 128)), jnp.zeros((2, h8, w8, 128)),
        jnp.zeros((2, h8, w8, 196)), jnp.zeros((2, h8, w8, 4)),
        jnp.asarray([0, 1]), 2, method=model.update_with_agg))(jax.random.PRNGKey(1))["params"]
    params = jax.tree.map(np.asarray, {**params, **uparams})
    params["update"]["delta_2"] = {k: v * np.float32(delta_scale)
                                   for k, v in params["update"]["delta_2"].items()}
    return model, params


def port_model(params):
    from dbaf_tpu_torch.models.convert import from_jax_params
    from dbaf_tpu_torch.models.net import DroidNet

    model = DroidNet(dtype=torch.float32, device="cpu")
    model.load_state_dict(from_jax_params(params))
    return model


def tiny_sample(rng, n_frames=N_FRAMES, h8=H8, w8=W8):
    """One covisible tuple as numpy arrays (tests/test_train.py's sample)."""
    poses_gt, disps_gt, intr, ii, jj = _tiny_problem(rng, n_frames, h8, w8)
    return dict(
        images=rng.integers(0, 255, size=(n_frames, 8 * h8, 8 * w8, 3)).astype(np.float32),
        poses0=np.tile(np.asarray(jlie.se3_identity())[None], (n_frames, 1)),
        disps0=np.ones((n_frames, h8, w8), np.float32),
        poses_gt=np.asarray(poses_gt), disps_gt=np.asarray(disps_gt),
        intrinsics=np.asarray(intr), ii=np.asarray(ii), jj=np.asarray(jj))


def to_torch(sample):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in sample.items()}


def test_forward_loss_and_every_gradient_match_jax():
    from dbaf_tpu_torch.train import losses as tlosses
    from dbaf_tpu_torch.train.unroll import forward as tforward

    rng = np.random.default_rng(SEED)
    s = tiny_sample(rng)
    jm, params = jax_params(delta_scale=0.01)
    js = {k: jnp.asarray(v) for k, v in s.items()}

    def j_loss(p):
        poses_list, disps_list, residuals = jforward(
            jm, p, js["images"], js["poses0"], js["disps0"], js["intrinsics"], js["ii"],
            js["jj"], num_steps=2)
        lg, _ = jlosses.geodesic_loss(js["poses_gt"], poses_list, js["ii"], js["jj"])
        lr, _ = jlosses.residual_loss(residuals)
        lf, _ = jlosses.flow_loss(js["poses_gt"], js["disps_gt"], poses_list,
                                  [d[:, 3::8, 3::8] for d in disps_list], js["intrinsics"])
        return lg + lr + 0.1 * lf, (poses_list, disps_list, residuals)

    (jval, (jposes, jdisps, jres)), jgrads = jax.jit(
        jax.value_and_grad(j_loss, has_aux=True))(params)

    tm = port_model(params)
    ts = to_torch(s)
    poses_list, disps_list, residuals = tforward(
        tm, ts["images"], ts["poses0"], ts["disps0"], ts["intrinsics"], ts["ii"], ts["jj"],
        num_steps=2)
    lg, _ = tlosses.geodesic_loss(ts["poses_gt"], poses_list, ts["ii"], ts["jj"])
    lr, _ = tlosses.residual_loss(residuals)
    lf, _ = tlosses.flow_loss(ts["poses_gt"], ts["disps_gt"], poses_list,
                              [d[:, 3::8, 3::8] for d in disps_list], ts["intrinsics"])
    tval = lg + lr + 0.1 * lf
    tval.backward()

    for name, jl, tl, atol in (("poses", jposes, poses_list, 1e-5),
                               ("disps_up", jdisps, disps_list, 5e-4),
                               ("residuals", jres, residuals, 1e-4)):
        assert len(jl) == len(tl) == 2
        for a, b in zip(jl, tl):
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=atol,
                                       err_msg=name)
    assert np.isfinite(float(jval))
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-5)

    from dbaf_tpu_torch.models.convert import from_jax_params

    jg = {k: g.numpy() for k, g in from_jax_params(jax.tree.map(np.asarray, jgrads)).items()}
    tg = {k: p.grad for k, p in tm.named_parameters()}
    assert set(jg) == set(tg)
    top = max(float(np.abs(g).max()) for g in jg.values())
    for k, g in jg.items():
        assert tg[k] is not None, k
        t = tg[k].numpy()
        assert np.all(np.isfinite(t)), k
        err = float(np.abs(t - g).max())
        assert err <= 1e-3 * float(np.abs(g).max()) + 1e-6 * top, (k, err)
