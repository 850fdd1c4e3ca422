"""DROID network in PyTorch: feature/context encoders + ConvGRU update operator.

Port of ``dbaf_tpu/models/net.py``.  The modules carry the JAX package's
fused layouts (GRU ``convzrq_i`` / ``convzr_n`` / ``convq_n`` /
``convzrq_glo`` and the ``dw_0`` delta|weight head), so
:func:`dbaf_tpu_torch.models.convert.from_jax_params` is a plain
HWIO -> OIHW transpose.  Public tensors are NHWC as in the JAX package;
inside, convolutions run on NCHW-shaped views of the NHWC data (channels-last
memory).

``dtype`` is the compute type.  In bf16 every convolution takes bf16
operands, sums in f32 and rounds its result to bf16, then adds a bf16 bias
(a second rounding), as Flax's ``nn.Conv(dtype=bf16)`` does; instance norm
runs in f32.  On the card the convolutions go to cuDNN in bf16; on the CPU
they run in f32 on the bf16-rounded operands and round the result, which is
the same function.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.corr_cuda import RAW_CHANNELS, raw_corr_index
from ..utils.device import device_const, resolve_device

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


class GradientClip(torch.autograd.Function):
    """Identity forward; backward zeroes NaN and |g| > 0.01
    (modules/clipping.py:7-24)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
        return torch.where(torch.abs(g) > 0.01, torch.zeros_like(g), g)


def gradient_clip(x: torch.Tensor) -> torch.Tensor:
    return GradientClip.apply(x)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` with each step in x's dtype: the expansion
    ``jax.nn.sigmoid`` lowers to, so bf16 results round alike."""
    return 1.0 / (1.0 + torch.exp(-x))


class Conv(nn.Conv2d):
    """Conv2d that computes in the network's dtype (see the module doc)."""

    def run(self, x: torch.Tensor, dtype: torch.dtype,
            weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``weight`` replaces the layer's own (the corr encoder's raw
        layout)."""
        weight = self.weight if weight is None else weight
        if dtype == torch.float32:
            return F.conv2d(x.float(), weight, self.bias, self.stride, self.padding)
        w = weight.to(dtype)
        if x.is_cuda:
            y = F.conv2d(x.to(dtype), w, None, self.stride, self.padding)
        else:
            y = F.conv2d(x.to(dtype).float(), w.float(), None, self.stride,
                         self.padding).to(dtype)
        if self.bias is not None:
            y = y + self.bias.to(dtype).view(1, -1, 1, 1)
        return y


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``InstanceNorm2d(affine=False)`` in f32, result in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=(-2, -1), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(-2, -1), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _norm(x: torch.Tensor, kind: str) -> torch.Tensor:
    return instance_norm(x) if kind == "instance" else x


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm: str, stride: int = 1):
        super().__init__()
        self.norm = norm
        self.conv1 = Conv(in_planes, planes, 3, stride=stride, padding=1)
        self.conv2 = Conv(planes, planes, 3, padding=1)
        self.downsample = Conv(in_planes, planes, 1, stride=stride) if stride != 1 else None

    def forward(self, x, dtype):
        y = F.relu(_norm(self.conv1.run(x, dtype), self.norm))
        y = F.relu(_norm(self.conv2.run(y, dtype), self.norm))
        if self.downsample is not None:
            x = _norm(self.downsample.run(x, dtype), self.norm)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """Stride-8 trunk (extractor.py:118-198): NCHW in, NCHW out."""

    def __init__(self, output_dim: int = 128, norm: str = "instance", dim: int = 32):
        super().__init__()
        self.norm = norm
        d = dim
        self.conv1 = Conv(3, d, 7, stride=2, padding=3)
        specs = ((d, d, 1), (d, 2 * d, 2), (2 * d, 4 * d, 2))
        for li, (cin, cout, stride) in enumerate(specs, start=1):
            setattr(self, f"layer{li}_0", ResidualBlock(cin, cout, norm, stride))
            setattr(self, f"layer{li}_1", ResidualBlock(cout, cout, norm, 1))
        self.conv2 = Conv(4 * d, output_dim, 1)

    def forward(self, x, dtype):
        x = F.relu(_norm(self.conv1.run(x, dtype), self.norm))
        for li in (1, 2, 3):
            x = getattr(self, f"layer{li}_0")(x, dtype)
            x = getattr(self, f"layer{li}_1")(x, dtype)
        return self.conv2.run(x, dtype)


class ConvGRU(nn.Module):
    """3x3 ConvGRU with the sigmoid-gated global-context path (gru.py:5-32),
    in the fused layout of the JAX package (net.py:143-184)."""

    def __init__(self, h: int = 128, i: int = 320):
        super().__init__()
        self.h = h
        self.w = Conv(h, h, 1)
        self.convzrq_glo = Conv(h, 3 * h, 1)
        self.convzrq_i = Conv(i, 3 * h, 3, padding=1)
        self.convzr_n = Conv(h, 2 * h, 3, padding=1, bias=False)
        self.convq_n = Conv(h, h, 3, padding=1, bias=False)

    def forward(self, net, inp, dtype):
        h = self.h
        glo = _sigmoid(self.w.run(net, dtype)) * net
        glo = glo.mean(dim=(2, 3), keepdim=True)
        gl = self.convzrq_glo.run(glo, dtype)
        a = self.convzrq_i.run(inp, dtype)
        zr = _sigmoid(a[:, : 2 * h] + self.convzr_n.run(net, dtype) + gl[:, : 2 * h])
        z, r = zr[:, :h], zr[:, h:]
        q = torch.tanh(a[:, 2 * h:] + self.convq_n.run(r * net, dtype) + gl[:, 2 * h:])
        return (1.0 - z) * net + z * q


class UpdateModule(nn.Module):
    """RAFT-style update operator (droid_net.py:74-142) with 2-channel
    delta/weight heads.

    The correlation input has the reference's 196 channels or kernel
    K1-raw's 1024 (its per-pixel 32 x 32 block, ``corr_fused_xy(...,
    raw=True)``).  For the raw layout the first corr-encoder conv's
    (128, 196) kernel -- still the only parameter, so checkpoints convert
    unchanged -- is scattered to the block positions by
    :func:`~dbaf_tpu_torch.ops.corr_cuda.raw_corr_index`, with zero rows
    off the diagonal blocks, as the JAX package's ``_CorrEnc0`` does
    (``dbaf_tpu/models/net.py:214-257``).  No update round passes the raw
    layout: the JAX package's do not either."""

    def __init__(self, corr_channels: int = 196):
        super().__init__()
        self.corr_encoder_0 = Conv(corr_channels, 128, 1)
        self.corr_encoder_2 = Conv(128, 128, 3, padding=1)
        self.flow_encoder_0 = Conv(4, 128, 7, padding=3)
        self.flow_encoder_2 = Conv(128, 64, 3, padding=1)
        self.gru = ConvGRU(128, 128 + 128 + 64)
        self.dw_0 = Conv(128, 256, 3, padding=1)
        self.delta_2 = Conv(128, 2, 3, padding=1)
        self.weight_2 = Conv(128, 2, 3, padding=1)

    def forward(self, net, inp, corr, flow, dtype):
        """NCHW-shaped net (E,128,H,W), inp (E,128,H,W), corr (E,196,H,W)
        or (E,1024,H,W) (the raw layout), flow (E,4,H,W).  Returns (net,
        delta f32, weight f32), NCHW."""
        c = F.relu(self.corr_encoder_0.run(corr, dtype, self._corr_weight(corr.shape[1])))
        c = F.relu(self.corr_encoder_2.run(c, dtype))
        f = F.relu(self.flow_encoder_0.run(flow, dtype))
        f = F.relu(self.flow_encoder_2.run(f, dtype))
        net = self.gru(net.to(dtype), torch.cat([inp.to(dtype), c, f], dim=1), dtype)
        dw = F.relu(self.dw_0.run(net, dtype))
        delta = gradient_clip(self.delta_2.run(dw[:, :128], dtype))
        weight = _sigmoid(gradient_clip(self.weight_2.run(dw[:, 128:], dtype)))
        return net, delta.float(), weight.float()

    def _corr_weight(self, channels: int) -> Optional[torch.Tensor]:
        """The first corr-encoder kernel for ``channels`` input channels:
        None (the layer's own) for 196, the raw-layout scatter for 1024."""
        enc = self.corr_encoder_0
        if channels == enc.in_channels:
            return None
        if channels != RAW_CHANNELS:
            raise ValueError(f"corr input has {channels} channels: expected "
                             f"{enc.in_channels} or the raw layout's {RAW_CHANNELS}")
        idx = device_const(raw_corr_index().tolist(), torch.int64, enc.weight.device)
        w = enc.weight.index_select(1, torch.clamp(idx, min=0))
        return torch.where((idx >= 0)[None, :, None, None], w, torch.zeros_like(w))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class DroidNet(nn.Module):
    """fnet (correlation features), cnet (context), update operator
    (droid_net.py:145-168).  All public tensors are NHWC.  ``device``
    defaults to the card and raises without one; pass ``"cpu"`` for the
    CPU."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.dtype = dtype
        self.fnet = BasicEncoder(output_dim=128, norm="instance")
        self.cnet = BasicEncoder(output_dim=256, norm="none")
        self.update = UpdateModule()
        # on the device once: a per-frame host->device copy would
        # synchronise the stream
        self.register_buffer("_mean", torch.tensor(IMAGE_MEAN), persistent=False)
        self.register_buffer("_std", torch.tensor(IMAGE_STD), persistent=False)
        self.to(resolve_device(device))

    def _normalize(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) BGR uint8-valued -> NCHW normalized RGB in dtype
        (droid_net.py:155-160)."""
        x = images.flip(-1).float() / 255.0
        return _nchw(((x - self._mean) / self._std).to(self.dtype))

    @torch.no_grad()
    def features_only(self, images: torch.Tensor) -> torch.Tensor:
        """fnet: (N, H/8, W/8, 128) in dtype."""
        return _nhwc(self.fnet(self._normalize(images), self.dtype))

    @torch.no_grad()
    def context_only(self, images: torch.Tensor):
        """cnet: (net = tanh, inp = relu), each (N, H/8, W/8, 128)."""
        ctx = self.cnet(self._normalize(images), self.dtype)
        return _nhwc(torch.tanh(ctx[:, :128])), _nhwc(F.relu(ctx[:, 128:]))

    @torch.no_grad()
    def update_step(self, net: torch.Tensor, inp: torch.Tensor, corr: torch.Tensor,
                    flow: Optional[torch.Tensor] = None):
        """One update: NHWC net (E,H,W,128), inp (E,H,W,128), corr
        (E,H,W,196) or the raw layout's (E,H,W,1024), flow (E,H,W,4).
        Returns (net in dtype, delta f32, weight f32), NHWC."""
        if flow is None:
            flow = torch.zeros(net.shape[:3] + (4,), dtype=net.dtype, device=net.device)
        dt = self.dtype
        net_n, delta, weight = self.update(
            _nchw(net.to(dt)), _nchw(inp.to(dt)), _nchw(corr.to(dt)), _nchw(flow.to(dt)), dt
        )
        return _nhwc(net_n), _nhwc(delta), _nhwc(weight)

    def update_fn(self, net: torch.Tensor, inp: torch.Tensor, corr: torch.Tensor,
                  motn: torch.Tensor, ii: torch.Tensor, jj: torch.Tensor, aux: dict):
        """:meth:`update_step` with the graph's update-operator signature
        ``(net, inp, corr, motn, ii, jj, aux)`` (edge endpoints and the
        round's ``aux`` are unused by the network)."""
        return self.update_step(net, inp, corr, motn)
