"""Keyframe state store (port of ``dbaf_tpu/slam/video.py``).

Poses, disparities, damping and the feature/context buffers are
preallocated tensors on the device, written in place where the JAX package
donates its buffers; timestamps and thumbnails stay on the host.  The
visual path's rows: ring buffers, ``append``, ``rm_keyframe``, ``rollup``,
``distance``, ``seed_next`` and ``normalize``.  Depth-sensor rows, the
stereo feature buffer and the ``.pkl`` archive come with later slices.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..ops import projective as pj
from ..utils.config import DBAFusionConfig
from ..utils.device import resolve_device


class DepthVideo:
    """Fixed-capacity keyframe ring with device-resident hot state.
    ``device`` defaults to the card and raises without one."""

    _SHIFT_BUFFERS = ("poses", "disps", "damping", "fmaps", "nets", "inps")

    def __init__(self, cfg: DBAFusionConfig, device: Optional[Union[str, torch.device]] = None):
        if cfg.stereo or cfg.upsample or cfg.save_pkl:
            raise NotImplementedError(
                "dbaf_tpu_torch: stereo, upsample and save_pkl are not ported yet "
                "(the port's first slice is the monocular visual path)")
        self.cfg = cfg
        self.device = device = resolve_device(device)
        ht, wd = cfg.image_size
        h8, w8 = ht // 8, wd // 8
        B = cfg.buffer
        self.ht, self.wd, self.h8, self.w8 = ht, wd, h8, w8
        self.counter = 0
        self.tstamp = np.zeros(B, dtype=np.float64)
        kw = dict(device=device)
        self.poses = torch.zeros((B, 7), dtype=torch.float32, **kw)
        self.poses[:, 6] = 1.0
        self.disps = torch.ones((B, h8, w8), dtype=torch.float32, **kw)
        self.damping = torch.full((B, h8, w8), 1e-6, dtype=torch.float32, **kw)
        self.fmaps = torch.zeros((B, h8, w8, 128), dtype=torch.bfloat16, **kw)
        self.nets = torch.zeros((B, h8, w8, 128), dtype=torch.bfloat16, **kw)
        self.inps = torch.zeros((B, h8, w8, 128), dtype=torch.bfloat16, **kw)
        self.intrinsics = torch.zeros((4,), dtype=torch.float32, **kw)  # at 1/8 scale
        self.images_small = np.zeros((B, h8, w8, 3), dtype=np.uint8)
        self.imu_enabled = False

    # ------------------------------------------------------------------
    def append(self, tstamp: float, image_small: Optional[np.ndarray], pose: Optional[torch.Tensor],
               disp: Optional[float], intrinsics: torch.Tensor, fmap: torch.Tensor,
               net: torch.Tensor, inp: torch.Tensor) -> int:
        """Add a keyframe at the next slot; returns its index."""
        idx = self.counter
        self.tstamp[idx] = tstamp
        if image_small is not None:
            self.images_small[idx] = image_small
        if pose is not None:
            self.poses[idx] = pose
        if disp is not None:
            self.disps[idx] = disp
        self.intrinsics = intrinsics
        self.set_features(idx, fmap, net, inp)
        self.counter += 1
        return idx

    def set_features(self, idx: int, fmap, net, inp):
        self.fmaps[idx] = fmap
        self.nets[idx] = net
        self.inps[idx] = inp

    def set_pose(self, idx: int, pose: torch.Tensor):
        self.poses[idx] = pose

    def set_disp(self, idx: int, disp):
        self.disps[idx] = disp

    # ------------------------------------------------------------------
    def copy_row(self, dst: int, src: int):
        """Copy every per-frame row src -> dst (host rows included)."""
        for name in self._SHIFT_BUFFERS:
            buf = getattr(self, name)
            buf[dst] = buf[src]
        self.tstamp[dst] = self.tstamp[src]
        self.images_small[dst] = self.images_small[src]

    def rm_keyframe(self, ix: int):
        """Drop keyframe ``ix``, shifting slot ix+1 down (covisible_graph.py:180-195)."""
        self.copy_row(ix, ix + 1)
        self.counter -= 1

    def rollup(self, shift: int):
        """Shift the whole buffer down by ``shift`` slots (dbaf_frontend.py:89-151)."""
        for name in self._SHIFT_BUFFERS:
            buf = getattr(self, name)
            buf.copy_(torch.roll(buf, -shift, dims=0))
        self.tstamp = np.roll(self.tstamp, -shift)
        self.images_small = np.roll(self.images_small, -shift, axis=0)
        self.counter -= shift

    # ------------------------------------------------------------------
    def _idx(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=self.device)

    def distance(self, ii, jj, beta: float = 0.3) -> np.ndarray:
        d = pj.frame_distance_bidirectional(
            self.poses, self.disps, self.intrinsics, self._idx(ii), self._idx(jj), beta)
        return d.cpu().numpy()

    def normalize(self):
        """Scale disparities of the live rows to unit mean (poses scale along)."""
        n = self.counter
        s = self.disps[:n].mean()
        self.disps[:n] /= s
        self.poses[:n, :3] *= s

    def seed_next(self, idx: int):
        """poses[idx] = poses[idx-1]; disps[idx] = mean(disps[idx-1])
        (dbaf_frontend.py:371-373)."""
        self.poses[idx] = self.poses[idx - 1]
        self.disps[idx] = self.disps[idx - 1].mean()
