"""Tightly-coupled multi-sensor DBA: dense-BA Hessians inside the factor graph.

Port of ``dbaf_tpu/slam/coupled.py`` (the reference's multi-sensor BA,
depth_video.py:347-559).  The reduced camera system comes from the device
(``dba.coupled_hessian_full``); the IMU/GNSS/odometry/prior/marginal factor
graph is solved either on the host in f64 (``device_solver=False``) or on
the device in f32 (:mod:`dbaf_tpu_torch.fusion.device_graph`), and the pose
step goes back for the depth back-substitution and retraction
(``dba.coupled_retract_full``).

Sliding-window marginalization folds out-of-window visual, inertial and
GNSS information into a linear-container prior (depth_video.py:350-459),
with the bias-covariance reinflation path (:446-459); the device path keeps
that marginal on the device until a host consumer needs it.  Its upload
cache is keyed on a counter that every new marginal bumps, so a marginal
dropped by the GNSS initialization can never come back.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..fusion import device_graph as dg
from ..fusion.coupling import convert_dx, convert_hessian, hessian_factor
from ..fusion.factors import (
    B, V, X,
    BetweenVec, CombinedImuFactor, GPSFactor, Noise, PriorPose, PriorVec, VelFactor,
)
from ..fusion.graph import FactorGraph, LevenbergMarquardt, Values, marginalize_out
from ..fusion.se3np import Pose
from ..ops import dba
from ..utils import geodesy
from ..utils.config import DBAFusionConfig
from ..utils.device import to_host
from .multisensor import MultiSensorState
from .video import DepthVideo

GNSS_NOISE = Noise.sigmas([1.0, 1.0, 5.0], cauchy_k=0.08)  # depth_video.py:288-290
ODO_NOISE = Noise.sigmas([2.0, 2.0, 2.0])  # depth_video.py:300


class MultiSensorBA:
    """Owns the factor-graph state and drives the coupled iterations."""

    def __init__(self, video: DepthVideo, cfg: DBAFusionConfig):
        self.video = video
        self.cfg = cfg
        self.device = video.device
        self.state = MultiSensorState()
        self.last_t0 = 0
        self.last_t1 = 0
        self._marg_version = 0
        self._marg_factor = None
        self.prior_factor_map: Dict[int, list] = {}
        self.cur_result: Optional[Values] = None
        self.cur_ii = np.zeros(0, dtype=np.int64)
        self.cur_jj = np.zeros(0, dtype=np.int64)
        self.cur_target = None  # device (E, H, W, 2)
        self.cur_weight = None
        self.ignore_imu = False

        # extrinsics / georeferencing (set by the app)
        self.Tbc = Pose()          # body <- camera
        self.tbg = np.zeros(3)     # GNSS lever arm in body
        self.ten0 = None           # ECEF reference
        self.gnss_init_t1 = -1
        self.gnss_init_time = 0.0
        self.vi_init_t1 = -1
        self.vi_init_time = 0.0
        self.reinit = False
        self.init_pose_sigma = np.array([0.1, 0.1, 0.0001, 0.0001, 0.0001, 0.0001])
        self.init_bias_sigma = np.array([1.0, 1.0, 1.0, 0.1, 0.1, 0.1])

        # device solve state: the window state stays on the device across
        # the rounds of one keyframe step; sync_host() brings it back once
        self._fg_state = None    # flat (NW*21,) device tensor
        self._fg_pg = None       # PackedGraph of the per-round device path
        self._fg_key = None
        self._fg_synced = True
        self._A_dev = None
        self._Tbc12 = None
        self._lm_stats = None    # realized LM iterations of the last call
        self._fg_rows_np = None  # host state copy that rode the host pack
        self._mgd_cache = None   # ((t0, marginal version), device MargDense)
        self._marg_dev = None    # device-computed MargDense (or None)
        self._marg_dev_origin = -1

    # ------------------------------------------------------------------
    @property
    def marg_factor(self):
        return self._marg_factor

    @marg_factor.setter
    def marg_factor(self, f):
        self._marg_factor = f
        self._marg_version += 1

    def set_prior(self, t0: int, t1: int):
        """Anchor priors on the first two window states (depth_video.py:307-321).
        ``init_pose_sigma`` may be (2, 6): per-state sigmas."""
        for i in range(t0, t0 + 2):
            sig = self.init_pose_sigma
            if np.ndim(sig) > 1:
                sig = sig[i - t0]
            fs = [PriorPose(X(i), self.state.wTbs[i], Noise.sigmas(sig))]
            if not self.ignore_imu:
                fs.append(PriorVec(B(i), self.state.bs[i], Noise.sigmas(self.init_bias_sigma)))
            self.prior_factor_map[i] = fs
        self.last_t0 = t0
        self.last_t1 = t1

    def _gnss_factor(self, i: int) -> GPSFactor:
        """GPS factor with ECEF->local conversion + lever arm
        (depth_video.py:504-514)."""
        p = geodesy.Cen(self.ten0).T @ (self.state.gnss_position[i] - self.ten0)
        p = p - self.state.wTbs[i].R @ self.tbg
        return GPSFactor(X(i), p, GNSS_NOISE)

    def rm_new_gnss(self, t1: int):
        """Re-link GNSS/odometry measurements of a culled keyframe onto its
        predecessor inside the marginal (depth_video.py:272-304)."""
        has_gnss = self.gnss_init_t1 > 0 and self.state.gnss_valid[t1]
        has_odo = self.state.odo_valid[t1]
        if not (has_gnss or has_odo) or self._marg_host() is None:
            return
        graph = FactorGraph([self.marg_factor])
        values = Values(self.marg_factor.lin_point)

        def res(key, mirror):
            if self.cur_result is not None and key in self.cur_result:
                return self.cur_result[key]
            return mirror

        if has_gnss:
            T1, T0 = self.state.wTbs[t1], self.state.wTbs[t1 - 1]
            p = geodesy.Cen(self.ten0).T @ (self.state.gnss_position[t1] - self.ten0)
            p = p - self.state.wTbs[t1].R @ self.tbg
            p = p - T1.t + T0.t
            if X(t1 - 1) not in values:
                values[X(t1 - 1)] = res(X(t1 - 1), self.state.wTbs[t1 - 1])
            graph.add(GPSFactor(X(t1 - 1), p, GNSS_NOISE))
        if has_odo:
            v1 = self.state.wTbs[t1].R.T @ self.state.vs[t1]
            v0 = self.state.wTbs[t1 - 1].R.T @ self.state.vs[t1 - 1]
            v = self.state.odo_vel[t1] - v1 + v0
            if X(t1 - 1) not in values:
                values[X(t1 - 1)] = res(X(t1 - 1), self.state.wTbs[t1 - 1])
            if V(t1 - 1) not in values:
                values[V(t1 - 1)] = res(V(t1 - 1), self.state.vs[t1 - 1])
            graph.add(VelFactor(X(t1 - 1), V(t1 - 1), v, ODO_NOISE))
        self.marg_factor = graph.linearize_to_hessian(values)

    # ------------------------------------------------------------------
    def _edge_args(self, ii, jj, e_cap: int, s0: int):
        P = self.cfg.ba.window
        n = len(ii)
        ii_pad = np.zeros(e_cap, dtype=np.int64)
        jj_pad = np.zeros(e_cap, dtype=np.int64)
        ii_pad[:n] = np.clip(np.asarray(ii) - s0, 0, P - 1)
        jj_pad[:n] = np.clip(np.asarray(jj) - s0, 0, P - 1)
        mask = np.zeros(e_cap, dtype=bool)
        mask[:n] = True
        d = self.device
        return (torch.as_tensor(ii_pad, device=d), torch.as_tensor(jj_pad, device=d),
                torch.as_tensor(mask, device=d))

    def _gather_rows(self, arr: torch.Tensor, sel: np.ndarray) -> torch.Tensor:
        """Rows ``sel`` of a padded edge array, zero-padded to its length."""
        sel_pad = np.zeros(arr.shape[0], dtype=np.int64)
        sel_pad[: len(sel)] = sel
        return arr[torch.as_tensor(sel_pad, device=arr.device)]

    def _vis_hessian(self, ii, jj, target, weight, s0: int, t0: int, t1: int):
        """Device reduced camera system over window [t0, t1) at slot origin
        s0 = t0; returns host f64 (H, v) of size (t1-t0)*6, in one read."""
        P = self.cfg.ba.window
        ii_d, jj_d, mask = self._edge_args(ii, jj, target.shape[0], s0)
        v = self.video
        S, vv = dba.coupled_hessian_full(v.poses, v.disps, v.damping, v.intrinsics, target,
                                         weight, ii_d, jj_d, mask, s0, t1 - s0, P=P,
                                         eps_damping=self.cfg.ba.eps_damping)
        m = (t1 - t0) * 6
        Sv = to_host(torch.cat([S, vv[:, None]], dim=1)).astype(np.float64)
        return Sv[:m, :m], Sv[:m, -1]

    def _values_for(self, frames) -> Values:
        vals = Values()
        for i in frames:
            vals[X(i)] = self.state.wTbs[i]
            vals[V(i)] = self.state.vs[i]
            vals[B(i)] = self.state.bs[i]
        return vals

    # ------------------------------------------------------------------
    def _marg_host(self):
        """Host LinearContainerFactor view of the marginal; a device
        marginal is pulled once and becomes the host copy."""
        if self._marg_dev is not None:
            flat = to_host(torch.cat([a.reshape(-1).float() for a in self._marg_dev]))
            md, o = [], 0
            for a in self._marg_dev:
                md.append(flat[o: o + a.numel()].reshape(a.shape))
                o += a.numel()
            md[0] = md[0] > 0.5
            self.marg_factor = dg.marg_dense_to_factor(dg.MargDense(*md), self._marg_dev_origin)
            self._marg_dev = None
            self._mgd_cache = None
        return self.marg_factor

    def _marg_idx(self, t0: int):
        """Edges whose visual information folds into the marginal on a
        window advance (depth_video.py:354-360)."""
        return ((self.cur_ii >= self.last_t0) & (self.cur_ii < t0)
                & (self.cur_ii < self.last_t1 - 2) & (self.cur_jj < self.last_t1 - 2))

    def _marginalize_device(self, t0: int, t1: int) -> bool:
        """Window-advance marginalization on the device with no host read;
        the marginal stays there until a host consumer materializes it.
        Returns False to fall back to the host f64 path (reinit inflation,
        capacity miss)."""
        NW = self.cfg.sensors.fg_cap
        P = self.cfg.ba.window
        m = t0 - self.last_t0
        n_old = self.last_t1 - self.last_t0
        if self.reinit or m <= 0 or n_old > NW or NW > P:
            return False
        marg_idx = self._marg_idx(t0)
        marg_ii = self.cur_ii[marg_idx]
        marg_jj = self.cur_jj[marg_idx]
        marg_t1 = int(marg_jj.max()) + 1 if len(marg_ii) else t0 + 1
        if marg_t1 - self.last_t0 > NW:
            return False
        if len(marg_ii) > 0 and self.cur_target is None:
            return False
        pgf = dg.pack_graph_flat(self, self.last_t0, self.last_t1, NW)
        if pgf is None:
            return False
        mgd_old = self._mgd_device(self.last_t0, self.last_t1, NW)
        if mgd_old is None:
            return False
        fgf = dg.pack_state_flat(self, self.last_t0, self.last_t1, NW)

        # bookkeeping identical to the host path: the marginalized keyframes
        # go to the save_pkl archive
        if len(marg_ii) > 0:
            self.video.archive(self.video.archive_mark, t0)
        self.prior_factor_map.clear()

        if self.cur_target is not None:
            sel = np.nonzero(marg_idx)[0]
            tgt = self._gather_rows(self.cur_target, sel)
            wgt = self._gather_rows(self.cur_weight, sel)
        else:  # window advance before any coupled call: no visual info
            h8, w8 = self.video.disps.shape[1:]
            tgt = torch.zeros((1, h8, w8, 2), dtype=torch.float32, device=self.device)
            wgt = torch.zeros_like(tgt)
        ii_d, jj_d, mask = self._edge_args(marg_ii, marg_jj, tgt.shape[0], self.last_t0)
        blob = torch.as_tensor(np.concatenate([fgf, pgf]), device=self.device)
        v = self.video
        self._marg_dev = dg.marginalize_window_body(
            v.poses, v.disps, v.damping, v.intrinsics, tgt, wgt, ii_d, jj_d, mask,
            self.last_t0, dg.unflatten_state(blob[:NW * 21], n_old, NW),
            dg.unflatten_graph(blob[NW * 21:], NW), mgd_old, self._A_block(), m,
            marg_t1 - self.last_t0, P=P, NW=NW, eps_damping=self.cfg.ba.eps_damping)
        self._marg_dev_origin = t0
        self.marg_factor = None
        self._mgd_cache = None
        return True

    # ------------------------------------------------------------------
    def _marginalize(self, t0: int, t1: int, itrs: int):
        """Window-advance marginalization in host f64 (depth_video.py:350-462)."""
        self._marg_host()
        marg_idx = self._marg_idx(t0)
        marg_ii = self.cur_ii[marg_idx]
        marg_jj = self.cur_jj[marg_idx]
        marg_paras: List[str] = []
        graph = FactorGraph()
        marg_t1 = t0 + 1

        if len(marg_ii) > 0:
            marg_t1 = int(marg_jj.max()) + 1
            for i in range(self.last_t0, t0):
                marg_paras.append(X(i))
            # every row below the new origin not archived yet: from the
            # archive mark, which is last_t0 unless an advance without
            # marginalized edges, or the asynchronous pipeline's device
            # marginalization, left rows below it (the JAX package archives
            # from last_t0, and those rows then miss the archive)
            self.video.archive(self.video.archive_mark, t0)
            sel = np.nonzero(marg_idx)[0]
            tgt = self._gather_rows(self.cur_target, sel)
            wgt = self._gather_rows(self.cur_weight, sel)
            H, v = self._vis_hessian(marg_ii, marg_jj, tgt, wgt, self.last_t0, self.last_t0,
                                     marg_t1)
            H[np.arange(6), np.arange(6)] += 0.00025  # stability (:399)
            Hg, vg = convert_hessian(H, v, self.Tbc)
            frames = list(range(self.last_t0, marg_t1))
            graph.add(hessian_factor(frames, self._values_for(frames), Hg, vg))

        for i in range(self.last_t0, marg_t1):
            if i < t0:
                if X(i) not in marg_paras:
                    marg_paras.append(X(i))
                if not self.ignore_imu:
                    marg_paras += [V(i), B(i)]
                    graph.add(CombinedImuFactor(X(i), V(i), X(i + 1), V(i + 1), B(i), B(i + 1),
                                                self.state.preintegrations[i]))
                if self.gnss_init_t1 > 0 and self.state.gnss_valid[i]:
                    graph.add(self._gnss_factor(i))
                if self.state.odo_valid[i]:
                    graph.add(VelFactor(X(i), V(i), self.state.odo_vel[i], ODO_NOISE))

        for i in sorted(list(self.prior_factor_map.keys())):
            if i < t0:
                for f in self.prior_factor_map[i]:
                    graph.add(f)
            del self.prior_factor_map[i]
        if self.marg_factor is not None:
            graph.add(self.marg_factor)

        values = self._values_for(range(self.last_t0, max(marg_t1, t1)))
        if self.cur_result is not None:
            for k, val in self.cur_result.items():
                values[k] = val
        self.marg_factor = marginalize_out(graph, values, marg_paras)

        # bias-covariance inflation on reinit (depth_video.py:446-459)
        if self.reinit:
            rekeyed = self.marg_factor.rekey({B(t0): B(0)})
            g2 = FactorGraph([rekeyed])
            g2.add(BetweenVec(B(0), B(t0), np.zeros(6), Noise.sigmas(self.init_bias_sigma)))
            vals2 = Values(rekeyed.lin_point)
            vals2[B(t0)] = vals2[B(0)]
            self.marg_factor = marginalize_out(g2, vals2, [B(0)])
            self.reinit = False

    def _advance_window(self, t0: int, t1: int, itrs: int) -> int:
        """Move the window to [t0, t1), marginalizing what falls out;
        returns the window origin (never below the last one)."""
        if self.last_t1 != t1 or self.last_t0 != t0:
            self.sync_host()  # marginalization reads host-side state
            if self.last_t0 >= t0:
                t0 = self.last_t0
            elif not (self.cfg.sensors.device_solver and self.cfg.sensors.device_marg
                      and self._marginalize_device(t0, t1)):
                self._marginalize(t0, t1, itrs)
            self.last_t0 = t0
            self.last_t1 = t1
        return t0

    # ------------------------------------------------------------------
    def ba(self, ii_full, jj_full, valid, target, weight, t1: int, itrs: int = 2,
           reuse_state: bool = False):
        """One coupled multi-sensor DBA call (depth_video.py:347-559).

        ii_full/jj_full/valid: host padded edge endpoints + validity, rows
        aligned with the device target/weight arrays (active + inactive
        combined, confidence-weighted)."""
        ii_full = np.asarray(ii_full)
        jj_full = np.asarray(jj_full)
        valid = np.asarray(valid, bool)
        t0 = int(min(ii_full[valid].min(), jj_full[valid].min()))
        t0 = self._advance_window(t0, t1, itrs)

        sel = np.nonzero(valid & (ii_full >= t0) & (jj_full >= t0))[0]
        self.cur_ii = ii_full[sel]
        self.cur_jj = jj_full[sel]
        e_cap = target.shape[0]
        self.cur_target = self._gather_rows(target, sel)
        self.cur_weight = self._gather_rows(weight, sel)

        if self.cfg.sensors.device_solver and self._ba_device(t0, t1, e_cap, reuse_state):
            return

        # host f64 factor graph (the non-visual part built once)
        self.sync_host()
        base = FactorGraph()
        if not self.ignore_imu:
            for i in range(t0 + 1, t1):
                base.add(CombinedImuFactor(X(i - 1), V(i - 1), X(i), V(i), B(i - 1), B(i),
                                           self.state.preintegrations[i - 1]))
        for i in sorted(self.prior_factor_map.keys()):
            if t0 <= i < t1:
                for f in self.prior_factor_map[i]:
                    base.add(f)
        if self._marg_host() is not None:
            base.add(self.marg_factor)
        if self.gnss_init_t1 > 0:
            for i in range(t0, t1):
                if self.state.gnss_valid[i]:
                    base.add(self._gnss_factor(i))
        for i in range(t0, t1):
            if self.state.odo_valid[i]:
                base.add(VelFactor(X(i), V(i), self.state.odo_vel[i], ODO_NOISE))

        P = self.cfg.ba.window
        n_iters = 2  # coupled iterations (depth_video.py:524-558)
        ii_d, jj_d, mask = self._edge_args(self.cur_ii, self.cur_jj, e_cap, t0)
        m = (t1 - t0) * 6
        v = self.video
        eps = self.cfg.ba.eps_damping
        S, vv = dba.coupled_hessian_full(v.poses, v.disps, v.damping, v.intrinsics,
                                         self.cur_target, self.cur_weight, ii_d, jj_d, mask,
                                         t0, t1 - t0, P=P, eps_damping=eps)
        for it in range(n_iters):
            Sv = to_host(torch.cat([S[:m, :m], vv[:m, None]], dim=1)).astype(np.float64)
            Hg, vg = convert_hessian(Sv[:, :m], Sv[:, m], self.Tbc)
            frames = list(range(t0, t1))
            initial = self._values_for(frames)
            graph = FactorGraph(base.factors + [hessian_factor(frames, initial, Hg, vg)])
            if self.ignore_imu:
                for i in frames:
                    initial.pop(V(i), None)
                    initial.pop(B(i), None)
            result = LevenbergMarquardt(graph, initial).optimize()
            self.cur_result = result

            dx_body = np.zeros((t1 - t0) * 6)
            for i in frames:
                dx_body[(i - t0) * 6:(i - t0) * 6 + 6] = self.state.wTbs[i].local(result[X(i)])
                self.state.wTbs[i] = result[X(i)]
                if not self.ignore_imu:
                    self.state.vs[i] = result[V(i)]
                    self.state.bs[i] = result[B(i)]
            dx_full = np.zeros((P, 6), dtype=np.float32)
            dx_full[: t1 - t0] = convert_dx(dx_body, self.Tbc).reshape(-1, 6)
            _, _, S, vv = dba.coupled_retract_full(
                v.poses, v.disps, v.damping, v.intrinsics, self.cur_target, self.cur_weight,
                ii_d, jj_d, mask, t0, t1 - t0, torch.as_tensor(dx_full, device=self.device),
                P=P, eps_damping=eps, with_hessian=(it + 1 < n_iters))

    # ------------------------------------------------------------------
    def prepare_device(self, ii_full, jj_full, valid, t1: int, itrs: int):
        """Host prologue of the fused coupled keyframe step
        (slam/coupled_fused.py): window advance + marginalization + factor
        packing into one upload.  Returns the device operands, or None to
        fall back to the per-round host/device paths."""
        ii_full = np.asarray(ii_full)
        jj_full = np.asarray(jj_full)
        valid = np.asarray(valid, bool)
        t0 = int(min(ii_full[valid].min(), jj_full[valid].min()))
        t0 = self._advance_window(t0, t1, itrs)

        NW = self.cfg.sensors.fg_cap
        P = self.cfg.ba.window
        n = t1 - t0
        if n > NW or NW > P:
            return None
        sel = np.nonzero(valid & (ii_full >= t0) & (jj_full >= t0))[0]
        self.cur_ii = ii_full[sel]
        self.cur_jj = jj_full[sel]
        e_all = len(valid)
        self.sync_host()
        pgf = dg.pack_graph_flat(self, t0, t1, NW)
        if pgf is None:
            return None
        mgd = self._mgd_device(t0, t1, NW)
        if mgd is None:
            return None
        # one upload for everything the step needs this keyframe: [graph |
        # state | sel | ii | jj | mask] (indices are small ints, exact in f32)
        nn = len(self.cur_ii)
        idx = np.zeros((4, e_all), np.float32)
        idx[0, :nn] = sel
        idx[1, :nn] = np.clip(self.cur_ii - t0, 0, P - 1)
        idx[2, :nn] = np.clip(self.cur_jj - t0, 0, P - 1)
        idx[3, :nn] = 1.0
        blob = torch.as_tensor(
            np.concatenate([pgf, dg.pack_state_flat(self, t0, t1, NW), idx.reshape(-1)]),
            device=self.device)
        G = dg.graph_flat_size(NW)
        o = G + NW * 21
        idx_d = blob[o:].reshape(4, e_all)
        self._fg_key = (t0, t1)
        return dict(pg=dg.unflatten_graph(blob[:G], NW), fg=dg.unflatten_state(blob[G:o], n, NW),
                    sel=idx_d[0].long(), ii=idx_d[1].long(), jj=idx_d[2].long(),
                    mask=idx_d[3] > 0.5, t0=t0, n=n, mgd=mgd, A=self._A_block())

    def _mgd_device(self, t0: int, t1: int, NW: int):
        """The dense marginal prior on the device, uploaded once per
        marginal (keyed on the marginal's version counter).  None when a key
        falls outside the window (host fallback)."""
        if self._marg_dev is not None and self._marg_dev_origin == t0:
            return self._marg_dev
        self._marg_host()  # origin mismatch: self-heal through the host
        key = (t0, self._marg_version)
        if self._mgd_cache is not None and self._mgd_cache[0] == key:
            return self._mgd_cache[1]
        md = dg.marg_dense_np(self.marg_factor, t0, t1, NW)
        if md is None:
            return None
        dev = dg.marg_to_device(md, self.device)
        self._mgd_cache = (key, dev)
        return dev

    # ------------------------------------------------------------------
    def _ba_device(self, t0: int, t1: int, e_cap: int, reuse_state: bool) -> bool:
        """The whole coupled call on the device (hessian -> LM -> retract).
        Returns False (host fallback) on capacity/layout misses.  Within one
        keyframe step's rounds the GNSS lever-arm correction stays at the
        first round's attitude (the host rebuilds it per round)."""
        NW = self.cfg.sensors.fg_cap
        P = self.cfg.ba.window
        n = t1 - t0
        if n > NW or NW > P:
            return False
        if not reuse_state or self._fg_key != (t0, t1) or self._fg_state is None:
            self.sync_host()
            pgf = dg.pack_graph_flat(self, t0, t1, NW)
            if pgf is None:
                return False
            self._fg_pg = dg.unflatten_graph(torch.as_tensor(pgf, device=self.device), NW)
            self._fg_state = torch.as_tensor(dg.pack_state_flat(self, t0, t1, NW),
                                             device=self.device)
            self._fg_key = (t0, t1)
        mgd = self._mgd_device(t0, t1, NW)
        if mgd is None:
            return False
        ii_d, jj_d, mask = self._edge_args(self.cur_ii, self.cur_jj, e_cap, t0)
        v = self.video
        _, _, fg, self._lm_stats = dg.coupled_rounds_body(
            v.poses, v.disps, v.damping, v.intrinsics, self.cur_target, self.cur_weight,
            ii_d, jj_d, mask, t0, n, dg.unflatten_state(self._fg_state, n, NW), self._fg_pg,
            mgd, self._A_block(), dg.sel_pose_for(NW, self.device), P=P, NW=NW,
            n_iters=self.cfg.ba.lm_iters, eps_damping=self.cfg.ba.eps_damping)
        self._fg_state = dg.flatten_state(fg)
        self._fg_synced = False
        self._fg_rows_np = None  # a stashed copy no longer matches the state
        return True

    def _A_block(self) -> torch.Tensor:
        """Cached device copy of the camera->body tangent adjoint
        (fusion/coupling.py ba2fg_block); Tbc is fixed after init."""
        if self._A_dev is None:
            from ..fusion.coupling import ba2fg_block

            self._A_dev = torch.as_tensor(ba2fg_block(self.Tbc), dtype=torch.float32,
                                          device=self.device)
        return self._A_dev

    def _Tbc12_dev(self) -> torch.Tensor:
        """Cached device copy of the body<-camera extrinsic as 12 floats
        [R(9)|t(3)], for the asynchronous step's pose seed
        (slam/coupled_async.py); Tbc is fixed after init."""
        if self._Tbc12 is None:
            self._Tbc12 = torch.as_tensor(np.concatenate([self.Tbc.R.reshape(9), self.Tbc.t]),
                                          dtype=torch.float32, device=self.device)
        return self._Tbc12

    def stash_state_rows(self, rows_flat_np):
        """Host copy of the flat window state that rode the host-pack read;
        sync_host consumes it with no extra read."""
        self._fg_rows_np = np.asarray(rows_flat_np, np.float64)

    def sync_host(self):
        """Bring the device window states back into the host bookkeeping
        (once per keyframe step): one flat (NW*21,) read, or none when the
        state rode the host-pack read."""
        if self._fg_synced or self._fg_state is None or self._fg_key is None:
            return
        t0, t1 = self._fg_key
        NW = self.cfg.sensors.fg_cap
        if self._fg_rows_np is not None:
            rows = self._fg_rows_np.reshape(NW, 21)
        else:
            rows = to_host(self._fg_state).astype(np.float64).reshape(NW, 21)
        result = Values()
        for i in range(t0, t1):
            f = i - t0
            self.state.wTbs[i] = Pose(rows[f, :9].reshape(3, 3), rows[f, 9:12])
            self.state.vs[i] = rows[f, 12:15]
            self.state.bs[i] = rows[f, 15:21]
            result[X(i)] = self.state.wTbs[i]
            result[V(i)] = self.state.vs[i]
            result[B(i)] = self.state.bs[i]
        self.cur_result = result
        self._fg_synced = True
        self._fg_rows_np = None  # one-shot: valid only for this state

    def invalidate_device_state(self):
        """Drop every device cache after the world frame was rewritten
        (GNSS initialization): the next solve rebuilds from the host."""
        self._fg_state = None
        self._fg_key = None
        self._fg_synced = True
        self._fg_rows_np = None
        self.cur_result = None
        self.marg_factor = None
        self._marg_dev = None
        self._marg_dev_origin = -1
        self._mgd_cache = None

    # ------------------------------------------------------------------
    def rollup(self, roll: int):
        """Rekey all graph state after a window shift (dbaf_frontend.py:106-151)."""
        self.last_t0 -= roll
        self.last_t1 -= roll
        self.cur_ii = self.cur_ii - roll
        self.cur_jj = self.cur_jj - roll
        mapping = {}
        for i in range(roll, roll + 200):
            mapping[X(i)] = X(i - roll)
            mapping[V(i)] = V(i - roll)
            mapping[B(i)] = B(i - roll)
        if self._marg_host() is not None:
            self.marg_factor = self.marg_factor.rekey(mapping)
        for fs in self.prior_factor_map.values():
            for f in fs:
                f.keys = tuple(mapping.get(k, k) for k in f.keys)
        self.prior_factor_map = {i - roll: fs for i, fs in self.prior_factor_map.items()}
        if self.cur_result is not None:
            new_res = Values()
            for k, val in self.cur_result.items():
                new_res[k[0] + str(int(k[1:]) - roll)] = val
            self.cur_result = new_res
        self.state.rollup(roll)
        # vi_init_t1 / gnss_init_t1 are "has initialized" flags compared
        # against 0; the reference never shifts them on rollup
