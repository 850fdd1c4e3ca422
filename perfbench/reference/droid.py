"""Plain DROID network on reference-format weights, for the benchmark's
comparison: the feature encoder (fnet), the context encoder (cnet) and one
step of the update operator, after DROID-SLAM's ``droid_net.py``,
``extractor.py`` and ``gru.py`` (Teed & Deng, NeurIPS 2021), with
DBA-Fusion's checkpoint layout (``module.``-prefixed keys, 3-channel update
heads of which the first 2 are used).

Every convolution runs in float32 (the caller turns TF32 off) unless a
quantizer ``q`` is given: then each convolution's input and kernel pass
through it first, which is how the control computes the same network in a
lower precision.  Tensors at the interface are channels-last, as the
port's ``DroidNet`` takes and returns them: images (N, H, W, 3) BGR in
0..255; features (N, H/8, W/8, C).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


class Droid:
    def __init__(self, sd: Dict[str, torch.Tensor], q: Quant = None):
        self.sd = {k[len("module."):] if k.startswith("module.") else k: v.float()
                   for k, v in sd.items()}
        self.q = q

    def conv(self, x: torch.Tensor, name: str, stride: int = 1, padding: int = 0,
             out: Optional[int] = None):
        """``out``: the first output channels only."""
        w, b = self.sd[name + ".weight"][:out], self.sd.get(name + ".bias")
        b = None if b is None else b[:out]
        if self.q is not None:
            x, w = self.q(x), self.q(w)
        return F.conv2d(x, w, b, stride, padding)

    # -- encoders (extractor.py: BasicEncoder, ResidualBlock) -------------
    def _block(self, x, name: str, stride: int, norm: bool):
        n = F.instance_norm if norm else (lambda t: t)
        y = F.relu(n(self.conv(x, name + ".conv1", stride, 1)))
        y = F.relu(n(self.conv(y, name + ".conv2", 1, 1)))
        if stride != 1:
            x = n(self.conv(x, name + ".downsample.0", stride, 0))
        return F.relu(x + y)

    def encoder(self, images: torch.Tensor, prefix: str, norm: bool) -> torch.Tensor:
        """(N, H, W, 3) BGR 0..255 -> (N, C, H/8, W/8)."""
        mean = torch.tensor(IMAGE_MEAN, device=images.device)
        std = torch.tensor(IMAGE_STD, device=images.device)
        x = ((images.flip(-1).float() / 255.0 - mean) / std).permute(0, 3, 1, 2)
        n = F.instance_norm if norm else (lambda t: t)
        x = F.relu(n(self.conv(x, prefix + ".conv1", 2, 3)))
        for layer, stride in ((1, 1), (2, 2), (3, 2)):
            x = self._block(x, f"{prefix}.layer{layer}.0", stride, norm)
            x = self._block(x, f"{prefix}.layer{layer}.1", 1, norm)
        return self.conv(x, prefix + ".conv2")

    def fnet(self, images: torch.Tensor) -> torch.Tensor:
        return self.encoder(images, "fnet", True).permute(0, 2, 3, 1)

    def cnet(self, images: torch.Tensor):
        """(net, inp): tanh and relu of the context's two halves."""
        ctx = self.encoder(images, "cnet", False)
        return (torch.tanh(ctx[:, :128]).permute(0, 2, 3, 1),
                F.relu(ctx[:, 128:]).permute(0, 2, 3, 1))

    # -- update operator (droid_net.py: UpdateModule, gru.py: ConvGRU) -----
    def update(self, net, inp, corr, flow):
        """One step on edges: channels-last net (E,H,W,128), inp (E,H,W,128),
        corr (E,H,W,196), flow (E,H,W,4).  Returns (net, delta, weight)
        channels-last, delta and weight with 2 channels."""
        nchw = lambda t: t.float().permute(0, 3, 1, 2)  # noqa: E731
        net, inp, corr, flow = nchw(net), nchw(inp), nchw(corr), nchw(flow)
        c = F.relu(self.conv(corr, "update.corr_encoder.0"))
        c = F.relu(self.conv(c, "update.corr_encoder.2", 1, 1))
        f = F.relu(self.conv(flow, "update.flow_encoder.0", 1, 3))
        f = F.relu(self.conv(f, "update.flow_encoder.2", 1, 1))
        x = torch.cat([inp, c, f], dim=1)
        glo = torch.sigmoid(self.conv(net, "update.gru.w")) * net
        glo = glo.mean(dim=(2, 3), keepdim=True)
        hx = torch.cat([net, x], dim=1)
        z = torch.sigmoid(self.conv(hx, "update.gru.convz", 1, 1)
                          + self.conv(glo, "update.gru.convz_glo"))
        r = torch.sigmoid(self.conv(hx, "update.gru.convr", 1, 1)
                          + self.conv(glo, "update.gru.convr_glo"))
        qh = torch.tanh(self.conv(torch.cat([r * net, x], dim=1), "update.gru.convq", 1, 1)
                        + self.conv(glo, "update.gru.convq_glo"))
        net = (1.0 - z) * net + z * qh
        delta = self.conv(F.relu(self.conv(net, "update.delta.0", 1, 1)), "update.delta.2", 1, 1,
                          out=2)
        weight = torch.sigmoid(self.conv(F.relu(self.conv(net, "update.weight.0", 1, 1)),
                                         "update.weight.2", 1, 1, out=2))
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        return nhwc(net), nhwc(delta), nhwc(weight)
