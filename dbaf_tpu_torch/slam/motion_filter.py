"""Per-frame keyframe admission filter (port of ``dbaf_tpu/slam/motion_filter.py``).

Every frame runs the feature encoder; one correlation lookup against the
last keyframe (kernel K2 on the card) and one update-operator step estimate
the mean flow, and frames above ``filter_thresh`` become keyframes
(motion_filter.py:12-93 of the reference).  The gate's scalar is read on
the host once per frame.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops import corr as corr_ops
from ..ops import corr_cuda
from ..ops import lie
from ..ops import projective as pj
from ..utils.config import DBAFusionConfig
from .video import DepthVideo


class MotionFilter:
    def __init__(self, video: DepthVideo, cfg: DBAFusionConfig, feat_fn: Callable,
                 ctx_fn: Callable, update_fn: Callable):
        """feat_fn(images (1,H,W,3) uint8) -> fmaps (1,H/8,W/8,128);
        ctx_fn(images) -> (net, inp); update_fn(net, inp, corr, motn) ->
        (net, delta, weight), all NHWC (``DroidNet.update_step``)."""
        self.video = video
        self.cfg = cfg
        self.thresh = cfg.frontend.filter_thresh
        self.feat = feat_fn
        self.ctx = ctx_fn
        self.update_fn = update_fn
        self._kf_fmap = None
        self._kf_net = None
        self._kf_inp = None

    def gate(self, image: torch.Tensor):
        """Features of the frame and its mean flow magnitude against the
        last keyframe (motion_filter.py:38-53)."""
        fmap_cur = self.feat(image)[0]
        H, W = fmap_cur.shape[0], fmap_cur.shape[1]
        vol = corr_ops.build_volume_nhwc(self._kf_fmap[None].to(torch.bfloat16),
                                         fmap_cur[None].to(torch.bfloat16))
        coords0 = pj.coords_grid(H, W, device=image.device)[None]
        corr = corr_cuda.corr_lookup(vol, coords0).permute(0, 2, 3, 1)
        net_kf = self._kf_net
        zero_motn = torch.zeros((1, H, W, 4), dtype=net_kf.dtype, device=image.device)
        _, delta, _ = self.update_fn(net_kf[None], self._kf_inp[None], corr.to(net_kf.dtype),
                                     zero_motn)
        return fmap_cur, torch.linalg.norm(delta[0].float(), dim=-1).mean()

    def track(self, tstamp: float, image: np.ndarray, intrinsics: Optional[np.ndarray] = None) -> bool:
        """Process one (H, W, 3) BGR frame; returns True if admitted."""
        v = self.video
        img = torch.as_tensor(np.asarray(image, dtype=np.uint8), device=v.device)[None]
        intr8 = torch.as_tensor(np.asarray(intrinsics, np.float32), device=v.device) / 8.0
        small = np.asarray(image[::8, ::8]).astype(np.uint8)
        if v.counter == 0:
            fmap = self.feat(img)[0]
            net, inp = self.ctx(img)
            self._store(fmap, net[0], inp[0])
            v.append(tstamp, small, lie.se3_identity(device=v.device), 1.0, intr8,
                     fmap, net[0], inp[0])
            return True
        fmap, delta = self.gate(img)
        if float(delta) > self.thresh:
            idx = v.counter
            net, inp = self.ctx(img)
            v.set_features(idx, fmap, net[0], inp[0])
            self._store(fmap, net[0], inp[0])
            v.tstamp[idx] = tstamp
            v.images_small[idx] = small
            v.intrinsics = intr8
            v.counter += 1
            return True
        return False

    def _store(self, fmap, net, inp):
        self._kf_fmap = fmap
        self._kf_net = net.to(torch.bfloat16)
        self._kf_inp = inp.to(torch.bfloat16)
