"""Frontend driver (port of ``dbaf_tpu/slam/frontend.py``): initialization,
the per-keyframe update, culling and rollup, for the visual path and the
tightly-coupled multi-sensor path (IMU ingestion, IMU-predicted pose
seeding, VI/GNSS initialization, preintegration merging on culls, bias
reinitialization, IMU-rate trajectory rows).

The JAX package defers the cull bookkeeping of a visual keyframe step to the
next frame's gate pull, to save a transport round trip.  The port resolves
it right after the step, from the same packed scalars; the state the next
frame sees is the same.  With ``device_solver``, ``coupled_mega`` and
``coupled_async`` on, the coupled path enters the zero-pull asynchronous
pipeline (``slam/coupled_async.py``) after a non-culled fused step and drains
back to the synchronous flow on a bias reinitialization; with
``device_solver`` off it runs the host f64 solve, as the JAX package does.

With ``cfg.frontend.monitor_dir`` a :class:`~dbaf_tpu_torch.eval.monitor.Monitor`
records every keyframe and dumps its panels at each rollup (the
reference's live window, dbaf_frontend.py:76-83, 278-314); the visual
keyframe step then runs as two update calls, as in the JAX package.  The
monitor's reads of device state happen only when it exists.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..fusion.se3np import Pose
from ..ops import lie, lie_np
from ..ops import projective as pj
from ..utils.config import DBAFusionConfig
from ..utils.device import to_host
from .graph import CovisibleGraph
from .initialization import init_gnss, init_imu_states, visual_imu_alignment
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
        self.count = 0
        self.warmup = fc.warmup
        self.vi_warmup = fc.vi_warmup
        self.max_age = gc.max_age
        self.active_window = fc.active_window
        self.keyframe_thresh = fc.keyframe_thresh
        self.translation_threshold = fc.translation_threshold
        self.beta = gc.beta
        self.iters1, self.iters2 = fc.iters1, fc.iters2

        # sensor streams (set_multisensor); rows: imu [t, gx, gy, gz (deg/s),
        # ax, ay, az]; gnss/odo [t, x, y, z]
        self.all_imu: Optional[np.ndarray] = None
        self.all_gnss: np.ndarray = np.zeros((0, 4))
        self.all_odo: np.ndarray = np.zeros((0, 4))
        self.all_stamp: Optional[np.ndarray] = None  # full-rate image stamps
        self.cur_imu_ii = 0
        self.cur_stamp_ii = 0
        self.visual_only = True
        self.visual_only_init = False
        self.use_zupt = cfg.sensors.use_zupt
        self.high_freq_output = True

        # (tstamp, camera-to-world 7-vec on the device) on the visual path,
        # (tstamp, body 7-vec in numpy) once the coupled path writes rows
        self.trajectory: List[Tuple[float, Union[torch.Tensor, np.ndarray]]] = []
        # f64 ECEF positions of the rows written after GNSS initialization,
        # keyed by trajectory index (dbaf_frontend.py:180-183, 270-272)
        self.trajectory_ecef: dict = {}
        self.did_rollup = False
        self.rollup_count = 0
        self.keyframe_steps = 0
        self.update_rounds = 0
        self.culls = 0
        self._casync = None  # the asynchronous coupled pipeline (slam/coupled_async.py)
        # the file-dump monitor (dbaf_frontend.py:76-83; covisible_graph.py:252-307)
        self.monitor = None
        if fc.monitor_dir:
            from ..eval.monitor import Monitor

            self.monitor = Monitor(fc.monitor_dir, debug_views=fc.monitor_debug)

    def set_multisensor(self, all_imu, all_gnss=None, all_odo=None, all_stamp=None,
                        visual_only: bool = False):
        self.all_imu = np.asarray(all_imu) if all_imu is not None else None
        self.all_gnss = np.asarray(all_gnss) if all_gnss is not None else np.zeros((0, 4))
        self.all_odo = np.asarray(all_odo) if all_odo is not None else np.zeros((0, 4))
        self.all_stamp = all_stamp
        self.visual_only = visual_only
        if not visual_only:
            self.iters1, self.iters2 = 2, 1

    @property
    def coupled(self):
        return self.graph.coupled

    def __call__(self):
        if not self.is_initialized and self.video.counter == self.warmup:
            self._initialize()
        elif self.is_initialized and self.t1 < self.video.counter:
            self._update()

    def drain_async(self):
        """Bring the asynchronous coupled pipeline's device state back into
        the host mirrors (terminate and other whole-state readers)."""
        if self._casync is not None and self._casync.active:
            self._casync.sync()

    # ------------------------------------------------------------------
    def _initialize(self):
        """dbaf_frontend.py:816-851."""
        self.t0 = 0
        self.t1 = self.video.counter
        g, v = self.graph, self.video
        g.add_neighborhood_factors(self.t0, self.t1, r=3)
        if self.all_imu is not None and self.coupled is not None:
            init_imu_states(self, self.all_imu, self.all_gnss, self.all_odo)
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

    # ------------------------------------------------------------------
    def _ingest_sensors(self, cur_t: float):
        """IMU drain + GNSS/ZUPT/odometry attachment (dbaf_frontend.py:162-220)."""
        state = self.coupled.state
        imu_rows = self.all_imu
        n_imu = len(imu_rows)
        if self.cur_imu_ii >= n_imu - 1:
            # IMU stream exhausted (video outlasts the IMU file): keep the
            # state timeline consistent and let tracking continue visually
            state.append_imu(cur_t, imu_rows[-1][4:7], np.deg2rad(imu_rows[-1][1:4]))
            state.append_img(cur_t)
            return
        while self.cur_imu_ii < n_imu - 1 and imu_rows[self.cur_imu_ii][0] < cur_t:
            imu = imu_rows[self.cur_imu_ii]
            # high-frequency IMU-rate output between keyframes
            if self.high_freq_output and self.video.imu_enabled and self.all_stamp is not None:
                while (self.cur_stamp_ii < len(self.all_stamp)
                       and imu[0] > float(self.all_stamp[self.cur_stamp_ii][0])):
                    st = float(self.all_stamp[self.cur_stamp_ii][0])
                    state.append_imu_temp(st, imu[4:7], np.deg2rad(imu[1:4]), True)
                    if st > state.timestamps[-1] and abs(cur_t - st) > 1e-3 and state.pose_temp:
                        self._write_traj_row(st, state.pose_temp.pose)
                    self.cur_stamp_ii += 1
                state.append_imu_temp(imu[0], imu[4:7], np.deg2rad(imu[1:4]))
            state.append_imu(imu[0], imu[4:7], np.deg2rad(imu[1:4]))
            self.cur_imu_ii += 1

        imu = imu_rows[self.cur_imu_ii]
        state.append_imu(cur_t, imu[4:7], np.deg2rad(imu[1:4]))
        state.append_img(cur_t)

        if len(self.all_gnss) > 0:
            g = bisect.bisect(list(self.all_gnss[:, 0]), cur_t - 1e-6)
            if 0 < g < len(self.all_gnss) and self.all_gnss[g, 0] - cur_t < 0.01:
                state.append_gnss(cur_t, self.all_gnss[g, 1:4])

        self._zupt_gate(cur_t)

        if len(self.all_odo) > 0:
            o = bisect.bisect(list(self.all_odo[:, 0]), cur_t - 1e-6)
            if 0 < o < len(self.all_odo) and self.all_odo[o, 0] - cur_t < 0.01:
                state.append_odo(cur_t, self.all_odo[o, 1:4])

        imu = imu_rows[self.cur_imu_ii]
        state.append_imu(imu[0], imu[4:7], np.deg2rad(imu[1:4]))
        self.cur_imu_ii += 1

    def _zupt_gate(self, cur_t: float) -> bool:
        """Zero-velocity-update gate (dbaf_frontend.py:206-209): when the
        merged preintegration interval below the window top spans > 3 s and
        the second-newest keyframe's velocity is under
        ``cfg.sensors.zupt_vel_thresh``, append a zero-velocity odometry
        factor.  Returns whether it fired."""
        state = self.coupled.state
        if self.use_zupt and len(state.preintegrations) > 2 and \
                state.preintegrations[self.t1 - 3].dt > 3.0:
            if np.linalg.norm(state.vs[self.t1 - 2]) < self.cfg.sensors.zupt_vel_thresh:
                state.append_odo(cur_t, np.zeros(3))
                return True
        return False

    def _write_traj_row(self, t: float, T: Pose):
        """Body-pose trajectory row; once georeferenced also its f64 ECEF
        position ``ten0 + Cen(ten0) @ p`` (dbaf_frontend.py:270-272; f32
        would quantize ECEF magnitudes to ~0.5 m)."""
        coupled = self.coupled
        if coupled is not None and coupled.gnss_init_t1 > 0 and coupled.ten0 is not None:
            from ..utils import geodesy

            self.trajectory_ecef[len(self.trajectory)] = (
                coupled.ten0 + geodesy.Cen(coupled.ten0) @ np.asarray(T.t, np.float64))
        q = lie_np.matrix_to_quat(np.asarray(T.R, np.float64))
        self.trajectory.append((t, np.concatenate([T.t, q]).astype(np.float32)))

    # ------------------------------------------------------------------
    def _rollup(self):
        """Shift the window down (dbaf_frontend.py:253-257).  It is index
        bookkeeping, so it moves ahead of the update (the reference
        interleaves it mid-keyframe)."""
        self.did_rollup = False
        if self.t1 > self.cfg.frontend.rollup_start:
            roll = self.cfg.frontend.rollup_shift
            self.video.rollup(roll)
            self.graph.shift_indices(roll)
            if self.coupled is not None and len(self.coupled.state) > 0:
                self.coupled.rollup(roll)
            self._roll_aux(roll)
            self.t1 -= roll
            self.count -= roll
            self.did_rollup = True
            self.rollup_count += 1

    def _roll_aux(self, roll: int):
        """Roll buffer-indexed aux entries (e.g. a test oracle's id_map,
        keyed by video slot) along with the video."""
        B = self.cfg.buffer
        self.graph.aux = {
            k: torch.roll(a, -roll, dims=0)
            if isinstance(a, torch.Tensor) and a.dim() >= 1 and a.shape[0] == B else a
            for k, a in self.graph.aux.items()}

    def _update(self):
        """dbaf_frontend.py:153-375."""
        self.count += 1
        self.t1 += 1
        fc = self.cfg.frontend
        g, v = self.graph, self.video
        multisensor = self.all_imu is not None and self.coupled is not None
        cur_t = float(v.tstamp[self.t1 - 1])

        if multisensor:
            # bias reinit 5 s after VI init (dbaf_frontend.py:158-160)
            if v.imu_enabled and cur_t - self.coupled.vi_init_time > 5.0:
                self.coupled.reinit = True
                self.coupled.vi_init_time = 1e9
            self._ingest_sensors(cur_t)
            # the zero-pull device keyframe step (slam/coupled_async.py): the
            # rollup runs inside it, so only a reinit drains back to the
            # synchronous flow below
            ca = self._casync
            if ca is not None and ca.active:
                if self.coupled.reinit:
                    ca.sync()
                else:
                    ca.step(cur_t)
                    return
            # IMU-predicted pose seed (dbaf_frontend.py:222-228)
            if v.imu_enabled:
                Twc = self.coupled.state.wTbs[-1].compose(self.coupled.Tbc)
                Tcw = np.linalg.inv(Twc.matrix())
                v.set_pose(self.t1 - 1, torch.as_tensor(lie_np.se3_from_matrix(Tcw),
                                                        dtype=torch.float32))

        if g.n > 0:  # edge lifecycle (dbaf_frontend.py:233-242)
            old = (g.ii < self.t1 - self.active_window) | (g.jj < self.t1 - self.active_window)
            if self.visual_only:
                stale = (g.age > self.max_age) & old
            else:
                stale = (g.age > self.max_age) | old
            g.rm_factors(stale, store=True)

        g.add_proximity_factors(
            self.t1 - 5, max(self.t1 - self.cfg.graph.frontend_window, 0),
            rad=self.cfg.graph.frontend_radius, nms=self.cfg.graph.frontend_nms,
            thresh=self.cfg.graph.frontend_thresh, beta=self.beta, remove=True)
        if v.has_depth:  # RGB-D: seed from the sensor (dbaf_frontend.py:247-248)
            v.seed_depth(self.t1 - 1)

        self._rollup()
        if not multisensor and self.monitor is None:
            self._update_visual_fused(cur_t)
            return
        if not multisensor:
            self._update_two_call(cur_t)
            return

        # fused coupled keyframe: iters1 rounds + the cull decision +
        # iters2 rounds unless culled
        mega = g.update_coupled_mega(self.iters1, self.iters2)
        if mega is not None:
            culled, _ = mega
            self.keyframe_steps += 1
            self.update_rounds += self.iters1 + (0 if culled else self.iters2)
            # trajectory row from the post-iters1 state (the reference
            # writes it before the keyframe removal, dbaf_frontend.py:261-274)
            dec = g.dec_pose
            self._write_traj_row(cur_t, Pose(dec[:9].reshape(3, 3).astype(np.float64),
                                             dec[9:12].astype(np.float64)))
            self._monitor_keyframe(cur_t)
            if culled:
                self._cull()
            self._maybe_init_gnss()
            self._maybe_upsample()
            v.seed_next(self.t1)
            self._maybe_activate_casync()
            return

        self._update_two_call(cur_t)

    def _cull(self):
        g = self.graph
        self.culls += 1
        g.rm_keyframe(self.t1 - 2)
        if self.coupled is not None and self.all_imu is not None:
            self.coupled.rm_new_gnss(self.t1 - 2)
            self.coupled.state.merge_keyframe(self.t1 - 2)
        self.t1 -= 1

    def _maybe_activate_casync(self):
        """Enter the asynchronous coupled pipeline once the state qualifies
        (CoupledAsync.can_activate)."""
        if not self.cfg.sensors.coupled_async:
            return
        # the pipeline feeds the monitor's keyframe rows from its drained
        # packs (CoupledAsync._monitor_from_pack); the debug views read the
        # edge state, which stays on the synchronous flow
        if self.monitor is not None and self.monitor.debug_views:
            return
        if self._casync is None:
            from .coupled_async import CoupledAsync

            self._casync = CoupledAsync(self)
        if not self._casync.active and self._casync.can_activate():
            self._casync.activate()

    def _maybe_init_gnss(self):
        c = self.coupled
        if self.video.imu_enabled and c.gnss_init_time <= 0.0 and len(self.all_gnss) > 0 \
                and c.ten0 is not None:
            init_gnss(self.video, c, self.t1, c.ten0)

    def _maybe_upsample(self):
        """The GraphAgg head after a keyframe step, with ``cfg.upsample``
        and weights that carry it (covisible_graph.py:239-240, 339-340)."""
        g = self.graph
        if self.cfg.upsample and g.agg_fn is not None:
            g.run_upsample(g.agg_fn)

    def _update_two_call(self, cur_t: float):
        """The keyframe step as two update calls around a host cull
        decision (dbaf_frontend.py:243-373): multi-sensor before VI
        initialization, with ``coupled_mega`` off, and where the window
        exceeds ``fg_cap``; visual with the monitor on."""
        g, v = self.graph, self.video
        multisensor = self.all_imu is not None and self.coupled is not None
        g.update(None, None, use_inactive=True, rounds=self.iters1)
        self.keyframe_steps += 1
        self.update_rounds += self.iters1
        if v.imu_enabled:
            self._write_traj_row(cur_t, self.coupled.state.wTbs[self.t1 - 1])
        else:
            self.trajectory.append((cur_t, lie.se3_inv(v.poses[self.t1 - 1])))
        self._monitor_keyframe(cur_t)

        # keyframe cull decision (dbaf_frontend.py:317-353); the distance
        # came with the update's pack
        pack = g.host_pack
        if pack is not None and not self.did_rollup:
            d = float(pack[g._prox_offset - 1])
        else:
            d = float(v.distance([self.t1 - 3], [self.t1 - 2], beta=self.beta)[0])
        cull = d < self.keyframe_thresh
        if v.imu_enabled and not cull:
            # translation hysteresis (dbaf_frontend.py:319-325): candidates
            # t1-10..t1-4 (the immediate neighbor t1-3 is excluded)
            lo = self.t1 - 10 if self.t1 > 10 else self.t1 - 6
            hyst = g.hyst_norms
            if hyst is not None and not self.did_rollup:
                cam_t = hyst[max(lo, 0) - (self.t1 - 10):7]
            else:
                win = to_host(v.poses[max(lo, 0): self.t1 - 1]).astype(np.float64)
                rel = lie_np.se3_mul(win[:-2], lie_np.se3_inv(win[-1])[None])
                cam_t = np.linalg.norm(rel[:, :3], axis=1)
            cull = bool(np.any(cam_t < self.translation_threshold))

        if cull:
            self._cull()
        else:
            g.update(None, None, use_inactive=True, rounds=self.iters2)
            self.update_rounds += self.iters2

        # VI / GNSS initialization triggers (dbaf_frontend.py:359-369)
        if multisensor and self.t1 > self.vi_warmup and self.coupled.vi_init_t1 < 0:
            self._try_init_vi(cur_t)
        self._maybe_init_gnss()
        self._maybe_upsample()
        v.seed_next(self.t1)

    def _monitor_keyframe(self, cur_t: float):
        """Record the keyframe in the monitor and, after a rollup, dump its
        panels and debug views (the reference refreshes its window there,
        dbaf_frontend.py:296-314)."""
        mon = self.monitor
        if mon is None:
            return
        g, v = self.graph, self.video
        T = np.eye(4)
        bg = None
        if self.all_imu is not None and self.coupled is not None and v.imu_enabled:
            P = self.coupled.state.wTbs[self.t1 - 1]
            T[:3, :3], T[:3, 3] = P.R, P.t
            bg = np.asarray(self.coupled.state.bs[self.t1 - 1][3:6])
        else:
            row = to_host(lie.se3_inv(v.poses[self.t1 - 1])).astype(np.float64)
            T[:3, :3] = lie_np.quat_to_matrix(row[3:7])
            T[:3, 3] = row[:3]
        mon.record_keyframe(cur_t, T, gyro_bias=bg)
        if not self.did_rollup:
            return
        mon.dump_summary()
        if not mon.debug_views or g.n == 0:
            return
        # the oldest keyframe's disparity (covisible_graph.py:253-263)
        mon.dump_disparity(to_host(v.disps[int(g.ii[0])]))
        # the (max ii, max ii - 5) edge's flow/weight overlay, as the
        # reference picks it, else the newest edge (covisible_graph.py:266-283)
        sel = np.nonzero((g.ii == g.ii.max()) & (g.jj == g.ii.max() - 5))[0]
        e = int(sel[0]) if len(sel) else int(np.argmax(g.ii))
        target = to_host(g.edges.target[e])
        coords0 = np.asarray(pj.coords_grid(target.shape[0], target.shape[1]))
        mon.dump_flow_weight(v.images_small[int(g.ii[e])], target, coords0,
                             to_host(g.edges.weight[e]))
        # the covisibility graph over the camera centres (covisible_graph.py:287-307)
        centers = lie_np.se3_inv(to_host(v.poses[:self.t1]).astype(np.float64))[:, :3]
        mon.dump_covisible(centers, g.ii, g.jj, g.ii_inac, g.jj_inac)

    def _update_visual_fused(self, cur_t: float):
        """The visual keyframe step in one fused call: iters1 rounds, the
        cull decision, iters2 rounds and seeding unless culled."""
        g, v = self.graph, self.video
        culled, _, traj_row = g.update_mega(self.iters1, self.iters2)
        self.trajectory.append((cur_t, traj_row))
        self.keyframe_steps += 1
        self.update_rounds += self.iters1 + (0 if culled else self.iters2)
        if culled:
            ix = self.t1 - 2
            self._cull()
            # slot-keyed aux leaves move with the culled row, as the
            # asynchronous visual step moves them
            g.aux = v.rm_keyframe_aux(g.aux, ix)
            v.seed_next(self.t1)
        self._maybe_upsample()

    # ------------------------------------------------------------------
    def _try_init_vi(self, cur_t: float):
        """Gyro-excitation-gated VI initialization (dbaf_frontend.py:434-515)."""
        state = self.coupled.state
        vels = []
        for i in range(self.t1 - 8, self.t1 - 1):
            pim = state.preintegrations[i]
            if pim.dt <= 0:
                return
            vels.append(pim.dv / pim.dt)
        vels = np.asarray(vels)
        var_g = float(np.sqrt(np.mean(np.linalg.norm(vels - vels.mean(0), axis=1) ** 2)))
        if var_g < 0.25:
            return  # IMU excitation not enough

        g = self.graph
        t0a, t1a = self.t1 - 8, self.t1
        visual_imu_alignment(self.video, self.coupled, t0a, t1a, ignore_lever=True)
        g.update(None, None, use_inactive=True)
        visual_imu_alignment(self.video, self.coupled, t0a, t1a, ignore_lever=False)
        g.update(None, None, use_inactive=True)
        visual_imu_alignment(self.video, self.coupled, t0a, t1a, ignore_lever=False)
        if not self.visual_only:
            self.video.imu_enabled = True
        else:
            self.visual_only_init = True
        self.coupled.set_prior(self.coupled.last_t0, self.t1)
        # skip full-rate stamps up to now (dbaf_frontend.py:361-366)
        if self.all_stamp is not None:
            for i in range(len(self.all_stamp)):
                if float(self.all_stamp[i][0]) >= cur_t + 1e-6:
                    self.cur_stamp_ii = i
                    break
        g.update(None, None, use_inactive=True)
        self.update_rounds += 3
