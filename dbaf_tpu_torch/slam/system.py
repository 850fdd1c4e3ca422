"""System facade (port of ``dbaf_tpu/slam/system.py``): wires the network,
keyframe store, motion filter, covisibility graph and frontend.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Union

import numpy as np
import torch

from ..models.net import DroidNet
from ..ops.corr_cuda import check_k1_shape
from ..utils.config import DBAFusionConfig
from ..utils.device import resolve_device
from .frontend import Frontend
from .graph import CovisibleGraph
from .motion_filter import MotionFilter
from .video import DepthVideo


class DBAFusion:
    """Streaming visual SLAM: feed frames with :meth:`track`.

    ``params`` is the port's DroidNet ``state_dict``
    (:mod:`dbaf_tpu_torch.models.convert` makes one from JAX parameters or a
    reference checkpoint); without it ``cfg.weights_path`` names a
    reference-format ``droid.pth``.  ``feat_fn``/``ctx_fn``/``update_fn``
    may be injected instead (test oracles), with the signatures of
    ``DroidNet.features_only``/``context_only``/``update_step``.  ``device`` defaults to the
    card and raises without one; pass ``device="cpu"`` for the plain path.
    On the card the image may be at most 1024 px wide (kernel K1's limit,
    :func:`~dbaf_tpu_torch.ops.corr_cuda.check_k1_shape`); a wider
    ``cfg.image_size`` raises ``ValueError`` here.
    ``dtype`` is the network's compute type.
    """

    def __init__(self, cfg: DBAFusionConfig, params: Optional[Mapping[str, torch.Tensor]] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 feat_fn: Optional[Callable] = None, ctx_fn: Optional[Callable] = None,
                 update_fn: Optional[Callable] = None, dtype: torch.dtype = torch.bfloat16):
        self.cfg = cfg
        if torch.device("cuda" if device is None else device).type == "cuda":
            # K1 runs in every update round: refuse a feature grid it does
            # not take here rather than in the first round (fnet's 128 channels)
            check_k1_shape(cfg.feat_size[1], 128)
        self.device = resolve_device(device)
        self.video = DepthVideo(cfg, self.device)
        self.model = None
        if update_fn is None or feat_fn is None or ctx_fn is None:
            if params is None:
                if cfg.weights_path is None:
                    raise ValueError("need weights_path/params or injected feat/ctx/update fns")
                from ..models.convert import load_reference_state_dict

                params = load_reference_state_dict(
                    torch.load(cfg.weights_path, map_location="cpu", weights_only=True))
            self.model = DroidNet(dtype=dtype, device=self.device)
            self.model.load_state_dict(params)
            self.model.eval()
            feat_fn = feat_fn or self.model.features_only
            ctx_fn = ctx_fn or self.model.context_only
            update_fn = update_fn or self.model.update_step
        self.graph = CovisibleGraph(self.video, update_fn, cfg)
        self.filter = MotionFilter(self.video, cfg, feat_fn, ctx_fn, update_fn)
        self.frontend = Frontend(self.video, self.graph, cfg)

    def set_multisensor(self, *args, **kwargs):
        return self.frontend.set_multisensor(*args, **kwargs)

    def track(self, tstamp: float, image: np.ndarray, depth: Optional[np.ndarray] = None,
              intrinsics: Optional[np.ndarray] = None, image_right: Optional[np.ndarray] = None):
        """Feed one (H, W, 3) BGR frame (dbaf.py:50-58)."""
        if depth is not None or image_right is not None:
            raise NotImplementedError("dbaf_tpu_torch: RGB-D and stereo input are not ported yet")
        self.filter.track(tstamp, image, intrinsics)
        self.frontend()

    @property
    def trajectory(self):
        return self.frontend.trajectory

    def terminate(self) -> np.ndarray:
        """Keyframe trajectory as (N, 8) ``[t, x, y, z, qx, qy, qz, qw]``
        (camera-to-world), pulled from the device in one transfer."""
        traj = self.frontend.trajectory
        if not traj:
            return np.zeros((0, 8))
        rows = torch.stack([p for _, p in traj]).cpu().numpy()
        t = np.asarray([ts for ts, _ in traj], np.float64)
        return np.concatenate([t[:, None], rows.astype(np.float64)], axis=1)
