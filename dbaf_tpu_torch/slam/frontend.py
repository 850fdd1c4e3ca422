"""Frontend driver (port of ``dbaf_tpu/slam/frontend.py``, visual path):
initialization, the per-keyframe fused update, culling and rollup.

The JAX package defers the cull bookkeeping of a keyframe step to the next
frame's gate pull, to save a transport round trip.  The port resolves it
right after the step, from the same packed scalars; the state the next
frame sees is the same.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..utils.config import DBAFusionConfig
from .graph import CovisibleGraph
from .video import DepthVideo


class Frontend:
    def __init__(self, video: DepthVideo, graph: CovisibleGraph, cfg: DBAFusionConfig):
        self.video = video
        self.graph = graph
        self.cfg = cfg
        fc, gc = cfg.frontend, cfg.graph
        self.t0 = 0
        self.t1 = 0
        self.is_initialized = False
        self.warmup = fc.warmup
        self.max_age = gc.max_age
        self.active_window = fc.active_window
        self.beta = gc.beta
        self.iters1, self.iters2 = fc.iters1, fc.iters2
        # (tstamp, camera-to-world 7-vec on the device)
        self.trajectory: List[Tuple[float, torch.Tensor]] = []
        self.keyframe_steps = 0
        self.update_rounds = 0
        self.culls = 0

    def set_multisensor(self, *args, **kwargs):
        raise NotImplementedError(
            "dbaf_tpu_torch: multi-sensor fusion arrives with the coupled-solve "
            "slice (slam/coupled.py, slam/coupled_fused.py, fusion/device_graph.py)")

    def __call__(self):
        if not self.is_initialized and self.video.counter == self.warmup:
            self._initialize()
        elif self.is_initialized and self.t1 < self.video.counter:
            self._update()

    # ------------------------------------------------------------------
    def _initialize(self):
        """dbaf_frontend.py:816-851."""
        self.t0 = 0
        self.t1 = self.video.counter
        g, v = self.graph, self.video
        g.add_neighborhood_factors(self.t0, self.t1, r=3)
        v.imu_enabled = False
        init_iters = self.cfg.frontend.init_iters
        g.update(1, use_inactive=True, rounds=init_iters)
        g.add_proximity_factors(0, 0, rad=2, nms=2, thresh=self.cfg.graph.frontend_thresh,
                                beta=self.beta, remove=False)
        g.update(1, use_inactive=True, rounds=2 * init_iters)
        self.update_rounds += 3 * init_iters
        v.set_pose(self.t1, v.poses[self.t1 - 1])
        v.set_disp(self.t1, v.disps[self.t1 - 4:self.t1].mean())
        self.is_initialized = True
        g.rm_factors(g.ii < self.warmup - 4, store=True)

    def _update(self):
        """dbaf_frontend.py:153-375, visual branch."""
        self.t1 += 1
        fc = self.cfg.frontend
        g, v = self.graph, self.video
        cur_t = float(v.tstamp[self.t1 - 1])

        if g.n > 0:  # edge lifecycle (dbaf_frontend.py:233-242)
            stale = (g.age > self.max_age) & (
                (g.ii < self.t1 - self.active_window) | (g.jj < self.t1 - self.active_window))
            g.rm_factors(stale, store=True)

        g.add_proximity_factors(
            self.t1 - 5, max(self.t1 - self.cfg.graph.frontend_window, 0),
            rad=self.cfg.graph.frontend_radius, nms=self.cfg.graph.frontend_nms,
            thresh=self.cfg.graph.frontend_thresh, beta=self.beta, remove=True)

        # the rollup is index bookkeeping, so it moves ahead of the update
        # (the reference interleaves it mid-keyframe, dbaf_frontend.py:253-257)
        if self.t1 > fc.rollup_start:
            roll = fc.rollup_shift
            v.rollup(roll)
            g.shift_indices(roll)
            self.t1 -= roll

        culled, _, traj_row = g.update_mega(self.iters1, self.iters2)
        self.trajectory.append((cur_t, traj_row))
        self.keyframe_steps += 1
        self.update_rounds += self.iters1 + (0 if culled else self.iters2)
        if culled:
            self.culls += 1
            g.rm_keyframe(self.t1 - 2)
            self.t1 -= 1
            v.seed_next(self.t1)
