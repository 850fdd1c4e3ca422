"""Per-frame keyframe admission filter (port of ``dbaf_tpu/slam/motion_filter.py``).

Every frame runs the feature encoder; one correlation lookup against the
last keyframe (kernel K2 on the card) and one update-operator step estimate
the mean flow, and frames above ``filter_thresh`` become keyframes
(motion_filter.py:12-93 of the reference).  The gate's scalar is read on
the host once per frame; the frame's upload does not synchronise.  The
gate itself (:func:`gate`) is a function of explicit state, which the
asynchronous visual step (``slam/async_pipeline.py``) runs without a read.
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
from ..utils.device import host_wait, to_host, upload
from ..utils.profiling import TRACER
from .video import DepthVideo


def gate(feat_fn: Callable, update_fn: Callable, image: torch.Tensor, kf_fmap: torch.Tensor,
         kf_net: torch.Tensor, kf_inp: torch.Tensor, whole: bool = False):
    """Features of ``image`` (1, H, W, 3) and its mean flow magnitude
    against the last keyframe's features, a 0-d device tensor that is never
    read here (motion_filter.py:38-53): one 4-level lookup of the
    keyframe-to-frame volume at the identity (kernel K2 on the card) and
    one update-operator step on edge 0 -> 0 with an empty aux.  ``whole``:
    the pyramid's levels pool whole blocks only (``cfg.corr_whole_blocks``)."""
    fmap_cur = feat_fn(image)[0]
    H, W = fmap_cur.shape[0], fmap_cur.shape[1]
    vol = corr_ops.build_volume_nhwc(kf_fmap[None].to(torch.bfloat16),
                                     fmap_cur[None].to(torch.bfloat16))
    coords0 = pj.coords_grid(H, W, device=image.device)[None]
    corr = corr_cuda.corr_lookup(vol, coords0, whole).permute(0, 2, 3, 1)
    zero_motn = torch.zeros((1, H, W, 4), dtype=kf_net.dtype, device=image.device)
    ii = torch.zeros((1,), dtype=torch.int64, device=image.device)
    _, delta, _ = update_fn(kf_net[None], kf_inp[None], corr.to(kf_net.dtype), zero_motn, ii, ii,
                            {})
    return fmap_cur, torch.linalg.norm(delta[0].float(), dim=-1).mean()


class MotionFilter:
    def __init__(self, video: DepthVideo, cfg: DBAFusionConfig, feat_fn: Callable,
                 ctx_fn: Callable, update_fn: Callable):
        """feat_fn(images (1,H,W,3) uint8) -> fmaps (1,H/8,W/8,128);
        ctx_fn(images) -> (net, inp); update_fn(net, inp, corr, motn, ii, jj,
        aux) -> (net, delta, weight), all NHWC (``DroidNet.update_fn``); the
        gate passes edge 0 -> 0 and an empty aux."""
        self.video = video
        self.cfg = cfg
        self.feat = feat_fn
        self.ctx = ctx_fn
        self.update_fn = update_fn
        self.kf_fmap = None  # the last keyframe's features (store)
        self.kf_net = None
        self.kf_inp = None

    def track(self, tstamp: float, image: np.ndarray, depth: Optional[np.ndarray] = None,
              intrinsics: Optional[np.ndarray] = None,
              image_right: Optional[np.ndarray] = None) -> bool:
        """Process one (H, W, 3) BGR frame; returns True if admitted.  The
        gate sees the left image only; an admitted frame's ``depth`` (H, W)
        goes to ``disps_sens`` and, with ``cfg.stereo``, the features of
        ``image_right`` to ``fmaps_right`` (motion_filter.py:111-191 of the
        JAX package), both uploaded without a read.  A ``gate`` span."""
        with TRACER("gate"):
            return self._admit(tstamp, image, depth, intrinsics, image_right)

    def _admit(self, tstamp, image, depth, intrinsics, image_right) -> bool:
        v = self.video
        img = upload(np.asarray(image, dtype=np.uint8), v.device)[None]
        intr8 = upload(np.asarray(intrinsics, np.float32), v.device) / 8.0
        small = np.asarray(image[::8, ::8]).astype(np.uint8)

        def sensors():
            d = None if depth is None else upload(np.asarray(depth, np.float32), v.device)
            fr = None
            if image_right is not None and v.fmaps_right is not None:
                fr = self.feat(upload(np.asarray(image_right, dtype=np.uint8), v.device)[None])[0]
            return d, fr

        if v.counter == 0:
            fmap = self.feat(img)[0]
            net, inp = self.ctx(img)
            self.store(fmap, net[0], inp[0])
            d, fr = sensors()
            v.append(tstamp, small, lie.se3_identity(device=v.device), 1.0, intr8,
                     fmap, net[0], inp[0], depth=d, fmap_right=fr)
            return True
        fmap, delta = gate(self.feat, self.update_fn, img, self.kf_fmap, self.kf_net,
                           self.kf_inp, self.cfg.corr_whole_blocks)
        with host_wait():  # the one read a frame makes (motion_filter.py:159)
            admit = to_host(delta) > self.cfg.frontend.filter_thresh
        if admit:
            idx = v.counter
            net, inp = self.ctx(img)
            v.set_features(idx, fmap, net[0], inp[0])
            v.set_sensors(idx, *sensors())
            self.store(fmap, net[0], inp[0])
            v.tstamp[idx] = tstamp
            v.images_small[idx] = small
            v.intrinsics = intr8
            v.counter += 1
            return True
        return False

    def store(self, fmap, net, inp):
        """The last keyframe's features, which the gate compares against."""
        self.kf_fmap = fmap
        self.kf_net = net.to(torch.bfloat16)
        self.kf_inp = inp.to(torch.bfloat16)
