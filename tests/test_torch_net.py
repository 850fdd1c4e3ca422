"""Port parity for the DROID network: dbaf_tpu_torch DroidNet against the
JAX package's Flax DroidNet on the same weights and inputs (CPU).

Weights: ``test_golden_trace.synth_state_dict`` (reference checkpoint
format) -> JAX ``convert_state_dict`` -> port ``from_jax_params``; the
port's own reference-format loader must give the same ``state_dict``.

Tolerances: f32 ``atol 1e-4`` (test_net.py's bound for the same modules;
sums run in another order).  bf16: the port rounds at the same points as
Flax (bf16 conv result, then bf16 bias add; f32 instance norm; sigmoid
expanded as 1/(1+exp(-x)) in bf16), so here the outputs agree to one bf16
ulp of the largest value (``2^-7 * max|ref|``); in practice they are
bit-equal at these shapes.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbaf_tpu.models.convert import convert_state_dict
from dbaf_tpu.models.net import DroidNet as JNet
from dbaf_tpu_torch.models.convert import from_jax_params, load_reference_state_dict
from dbaf_tpu_torch.models.net import DroidNet
from tests.test_golden_trace import DATA, synth_state_dict


@pytest.fixture(scope="module")
def weights():
    sd = synth_state_dict()
    params = convert_state_dict(sd)
    return sd, params, from_jax_params(params)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, size=(1, 32, 48, 3)).astype(np.uint8)
    E, H, W = 3, 4, 6
    net = np.tanh(rng.normal(size=(E, H, W, 128))).astype(np.float32)
    inp = np.maximum(rng.normal(size=(E, H, W, 128)), 0).astype(np.float32)
    corr = rng.normal(size=(E, H, W, 196)).astype(np.float32)
    flow = rng.normal(size=(E, H, W, 4)).astype(np.float32)
    return img, net, inp, corr, flow


def test_reference_loader_gives_same_state_dict(weights):
    sd, _, tsd = weights
    with open(os.path.join(DATA, "droid_sd_manifest.json")) as f:
        manifest = json.load(f)
    tsd2 = load_reference_state_dict(sd, manifest)
    assert set(tsd2) == set(tsd)
    for k in tsd:
        assert torch.equal(tsd[k], tsd2[k]), k
    model = DroidNet(device="cpu")
    model.load_state_dict(tsd2)  # strict: every key of the port's modules
    bad = dict(sd)
    bad.pop("module.update.gru.convz.weight")
    with pytest.raises(ValueError, match="convz"):
        load_reference_state_dict(bad, manifest)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fnet_cnet_update_match_jax(weights, dtype):
    _, params, tsd = weights
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jm = JNet(dtype=jdt)
    tm = DroidNet(dtype=tdt, device="cpu")
    tm.load_state_dict(tsd)
    img, net, inp, corr, flow = _inputs()

    def f32(x):
        return np.asarray(x).astype(np.float32) if not isinstance(x, torch.Tensor) \
            else x.float().numpy()

    def check(a, b, name):
        a, b = f32(a), f32(b)
        atol = 1e-4 if dtype == "float32" else 2 ** -7 * np.abs(a).max()
        np.testing.assert_allclose(b, a, atol=atol, err_msg=name)

    check(jm.apply({"params": params}, jnp.asarray(img), method=jm.features_only),
          tm.features_only(torch.tensor(img)), "fnet")
    jn, ji = jm.apply({"params": params}, jnp.asarray(img), method=jm.context_only)
    tn, ti = tm.context_only(torch.tensor(img))
    check(jn, tn, "cnet net")
    check(ji, ti, "cnet inp")
    ju = jm.apply({"params": params}, None, jnp.asarray(net, jdt), jnp.asarray(inp, jdt),
                  jnp.asarray(corr, jdt), jnp.asarray(flow, jdt))
    tu = tm.update_step(*(torch.tensor(x).to(tdt) for x in (net, inp, corr, flow)))
    for a, b, name in zip(ju[:3], tu, ("net", "delta", "weight")):
        check(a, b, name)
    assert tu[1].dtype == torch.float32 and tu[2].dtype == torch.float32


def test_gradient_clip_backward():
    from dbaf_tpu_torch.models.net import gradient_clip

    x = torch.zeros(4, requires_grad=True)
    y = gradient_clip(x)
    y.backward(torch.tensor([0.005, 0.02, float("nan"), -0.001]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray([0.005, 0.0, 0.0, -0.001], np.float32))


def _raw_layout(corr, seed=1):
    """corr (E,H,W,196) placed at its raw block positions
    (corr_cuda.raw_corr_index), random values everywhere else: the
    cross-level products the encoder must give zero weight."""
    from dbaf_tpu_torch.ops.corr_cuda import raw_corr_index

    idx = raw_corr_index()
    raw = np.random.default_rng(seed).normal(size=corr.shape[:3] + (1024,)).astype(np.float32)
    pos = np.where(idx >= 0)[0]
    raw[..., pos] = corr[..., idx[pos]]
    return raw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_accepts_raw_corr_layout(weights, dtype):
    """test_net.py::test_update_accepts_raw_corr_layout through the port:
    the update operator on the raw 1024-channel layout against the
    196-channel input, and against the JAX UpdateModule on the same raw
    input.  f32 ``atol 1e-4`` (test_net.py's bound: the zero rows change
    only the order of the sums); bf16 one ulp of the largest value, as
    above."""
    _, params, tsd = weights
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tm = DroidNet(dtype=tdt, device="cpu")
    tm.load_state_dict(tsd)
    _, net, inp, corr, flow = _inputs(2)
    raw = _raw_layout(corr)
    t = lambda x: torch.tensor(x).to(tdt)  # noqa: E731
    o196 = tm.update_step(t(net), t(inp), t(corr), t(flow))
    oraw = tm.update_step(t(net), t(inp), t(raw), t(flow))
    jm = JNet(dtype=jdt)
    jraw = jm.apply({"params": params}, None, jnp.asarray(net, jdt), jnp.asarray(inp, jdt),
                    jnp.asarray(raw, jdt), jnp.asarray(flow, jdt))
    assert tsd["update.corr_encoder_0.weight"].shape == (128, 196, 1, 1)
    for a, b, j, name in zip(o196, oraw, jraw[:3], ("net", "delta", "weight")):
        a, b, j = a.float().numpy(), b.float().numpy(), np.asarray(j).astype(np.float32)
        atol = 1e-4 if dtype == "float32" else 2 ** -7 * np.abs(j).max()
        np.testing.assert_allclose(b, a, atol=atol, err_msg=name)
        np.testing.assert_allclose(b, j, atol=atol, err_msg=name)
    with pytest.raises(ValueError, match="1024"):
        tm.update_step(t(net), t(inp), t(raw[..., :500]), t(flow))
