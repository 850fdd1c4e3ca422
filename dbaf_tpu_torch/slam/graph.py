"""Covisibility graph: edge lifecycle + the fused per-keyframe update step.

Port of ``dbaf_tpu/slam/graph.py`` (visual path).  Edge sets are
fixed-capacity padded tensors with a host-side numpy index view; membership
changes compose on the host and flush as one permutation gather.  One
update step runs reproject -> 4-level correlation lookup -> ConvGRU ->
weight heuristics -> dense BA for each round, eagerly, as a Python loop.

The correlation path is decided by the device of the feature buffers: on
the card every round runs kernel K1 (``corr_fused_xy``) on operands
prepared once per step; on the CPU the round builds the bf16 volume once
and runs ``lookup_fused`` on it, which is the path the JAX package takes on
the CPU (and that ``tests/data/golden_trace.npz`` recorded).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops import corr as corr_ops
from ..ops import corr_cuda
from ..ops import dba, lie
from ..ops import projective as pj
from ..utils.config import DBAFusionConfig
from .video import DepthVideo


class UpdateResult(NamedTuple):
    host_pack: torch.Tensor  # [cull..., prox dists...] on the device
    traj_row: Optional[torch.Tensor]  # camera-to-world 7-vec (mega step)


def corr_operands(fmaps_buf: torch.Tensor, ii: torch.Tensor, jj: torch.Tensor):
    """Round-invariant correlation operands of an edge set: the prepared
    bf16 features for K1 on the card, the bf16 volume on the CPU."""
    f1 = fmaps_buf[ii]
    f2 = fmaps_buf[jj]
    if f1.is_cuda:
        return corr_cuda.prepare_corr_fmaps(f1, f2)
    return (corr_ops.build_volume_nhwc(f1, f2),)


def corr_round(prep, coords1: torch.Tensor) -> torch.Tensor:
    """(E, H, W, 196) correlation features of one round."""
    if coords1.is_cuda:
        f1p, f2p = prep
        return corr_cuda.corr_fused_xy(f1p, f2p, coords1, coords1.shape[1], coords1.shape[2])
    (vol,) = prep
    return corr_ops.lookup_fused(vol, coords1).permute(0, 2, 3, 1)


class UpdateStep:
    """The fused update step (``make_update_kernel``'s visual ``do_ba``
    path, mega and per-round variants)."""

    def __init__(self, cfg: DBAFusionConfig, update_fn: Callable):
        self.cfg = cfg
        self.update_fn = update_fn

    def __call__(self, video: DepthVideo, edges, ii, jj, e_mask, t_inac, w_inac, ii_i, jj_i, i_mask,
                 t0: int, t1: int, s0: int, rounds: int, rounds_b: int, iters: int,
                 use_inactive: bool, mega: bool) -> UpdateResult:
        """Runs in place on ``video`` (poses, disps) and ``edges`` (net,
        target, weight).  Index arguments are device int64 tensors."""
        cfg = self.cfg
        P = cfg.ba.window
        EP = cfg.ba.eps_damping
        far_thresh = cfg.graph.far_threshold
        mask_thresh = cfg.graph.mask_threshold
        B = video.poses.shape[0]
        dev = video.poses.device
        intrinsics = video.intrinsics
        grid = pj.coords_grid(video.h8, video.w8, device=dev)
        prep = corr_operands(video.fmaps, ii, jj)
        inp_e = video.inps[ii]
        # window start as jax.lax.dynamic_slice clamps it
        sw = max(0, min(s0, B - P))
        m4 = e_mask[:, None, None, None]
        if use_inactive:
            inac = cfg.graph.inac_range
            keep_i = i_mask & (ii_i >= t0 - inac) & (jj_i >= t0 - inac)
            ii_all = torch.cat([ii_i, ii])
            jj_all = torch.cat([jj_i, jj])
            m_all = torch.cat([keep_i, e_mask])
        else:
            ii_all, jj_all, m_all = ii, jj, e_mask

        def one_round():
            poses, disps = video.poses, video.disps
            coords1, _ = pj.projective_transform(poses, disps, intrinsics, ii, jj)
            motn = torch.cat([coords1 - grid, edges.target - coords1], dim=-1).clamp(-64.0, 64.0)
            corr = corr_round(prep, coords1)
            net_dt = edges.net.dtype
            net_new, delta, weight_up = self.update_fn(
                edges.net, inp_e.to(net_dt), corr.to(net_dt), motn.to(net_dt))
            target = torch.where(m4, coords1 + delta.float(), edges.target)
            weight = torch.where(m4, weight_up.float(), torch.zeros((), device=dev))
            edges.net.copy_(torch.where(m4, net_new.to(net_dt), edges.net))
            edges.target.copy_(target)
            edges.weight.copy_(weight)

            if use_inactive:
                t_all = torch.cat([t_inac, target], dim=0)
                w_all = torch.cat([w_inac, weight], dim=0)
            else:
                t_all, w_all = target, weight

            # confidence heuristics (covisible_graph.py:309-328)
            imu_f = 1.0 if video.imu_enabled else 0.0
            neg = torch.full_like(ii_all, -1)
            max_i = torch.max(torch.where(m_all, ii_all, neg))
            max_j = torch.max(torch.where(m_all, jj_all, neg))
            wmul = torch.where(ii_all == max_i, 0.1, 1.0) * torch.where(jj_all == max_j, 0.25, 1.0)
            if mask_thresh > 0:
                tnorm = torch.linalg.norm(lie.se3_rel(poses[jj_all], poses[ii_all])[:, :3], dim=-1)
                wmul = wmul * torch.where((tnorm < mask_thresh) & (imu_f > 0), 1e-3, 1.0)
            w_ba = w_all * wmul.to(torch.float32)[:, None, None, None]
            if far_thresh > 0 and imu_f > 0:
                pixmask = (disps[ii_all] < far_thresh)[..., None]
                w_ba = torch.where(pixmask, w_ba * 1e-3, w_ba)

            # window-local BA, written back in place
            poses_w = poses[sw:sw + P]
            disps_w = disps[sw:sw + P]
            eta = 0.2 * video.damping[sw:sw + P].reshape(P, -1) + EP
            in_window = (ii_all >= s0) & (jj_all >= s0)
            m_ba = m_all & in_window
            ii_w = torch.clamp(ii_all - s0, 0, P - 1)
            jj_w = torch.clamp(jj_all - s0, 0, P - 1)
            state = dba.ba(poses_w, disps_w, intrinsics, t_all, w_ba, eta, ii_w, jj_w, m_ba,
                           t0 - s0, t1 - s0, iterations=iters, lm=cfg.ba.lm, ep=cfg.ba.ep,
                           alpha=cfg.ba.alpha)
            poses_w.copy_(state.poses)
            disps_w.copy_(state.disps)

        traj_row = None
        if not mega:
            for _ in range(rounds):
                one_round()
            pack = self.host_metrics(video, t1)
        else:
            # fused keyframe step (dbaf_frontend.py:243-373): rounds, the
            # cull decision on the state after them (one host read), then
            # rounds_b more and next-slot seeding unless the keyframe culls
            for _ in range(rounds):
                one_round()
            d_cull = self.cull_metric(video, t1)
            traj_row = lie.se3_inv(video.poses[t1 - 1])
            cull = float(d_cull) < cfg.frontend.keyframe_thresh
            if not cull:
                for _ in range(rounds_b):
                    one_round()
                video.seed_next(t1)
            flag = torch.full((1,), 1.0 if cull else 0.0, device=dev)
            pack = torch.cat([flag, d_cull.reshape(1), self.host_metrics(video, t1)[1:]])
        return UpdateResult(host_pack=pack, traj_row=traj_row)

    def cull_metric(self, video: DepthVideo, t1: int) -> torch.Tensor:
        """Keyframe-cull flow distance (dbaf_frontend.py:264)."""
        idx = lambda k: torch.tensor([k], device=video.poses.device)
        return pj.frame_distance_bidirectional(
            video.poses, video.disps, video.intrinsics, idx(t1 - 3), idx(t1 - 2),
            beta=self.cfg.graph.beta)[0]

    def host_metrics(self, video: DepthVideo, t1: int) -> torch.Tensor:
        """[cull distance, next keyframe's proximity candidate distances],
        computed on the end state with the incoming frame seeded
        (covisible_graph.py:379)."""
        cfg = self.cfg
        wf = cfg.graph.frontend_window
        n_skip = len(cfg.graph.skip_edge) if wf == 5 else 0
        poses, disps = video.poses, video.disps
        B = poses.shape[0]
        t_next = t1 + 1
        seed = min(max(t1, 0), B - 1)
        poses_x = poses.clone()
        disps_x = disps.clone()
        poses_x[seed] = poses[seed - 1]
        disps_x[seed] = disps[seed - 1].mean()
        ii_c = t_next - 5 + np.arange(5)
        jj_c = t_next - wf + np.arange(wf)
        pi = np.repeat(ii_c, wf)
        pj_ = np.tile(jj_c, 5)
        if n_skip:
            pi = np.concatenate([pi, np.full(n_skip, t_next - 1)])
            pj_ = np.concatenate([pj_, t_next - 5 + np.asarray(cfg.graph.skip_edge)])
        cand_i = np.clip(np.concatenate([[t1 - 3], pi]), 0, B - 1)
        cand_j = np.clip(np.concatenate([[t1 - 2], pj_]), 0, B - 1)
        dev = poses.device
        return pj.frame_distance_bidirectional(
            poses_x, disps_x, video.intrinsics,
            torch.as_tensor(cand_i, dtype=torch.int64, device=dev),
            torch.as_tensor(cand_j, dtype=torch.int64, device=dev), beta=cfg.graph.beta)


class EdgeArrays:
    """Per-edge device state: GRU hidden (bf16), target coords, weights."""

    def __init__(self, e_cap: int, h8: int, w8: int, device: torch.device):
        self.net = torch.zeros((e_cap, h8, w8, 128), dtype=torch.bfloat16, device=device)
        self.target = torch.zeros((e_cap, h8, w8, 2), dtype=torch.float32, device=device)
        self.weight = torch.zeros((e_cap, h8, w8, 2), dtype=torch.float32, device=device)


class CovisibleGraph:
    """Host-side edge manager around the fused update step."""

    def __init__(self, video: DepthVideo, update_fn: Callable, cfg: DBAFusionConfig):
        if cfg.graph.corr_int8:
            raise NotImplementedError("dbaf_tpu_torch: the int8 correlation variant is not ported")
        self.video = video
        self.cfg = cfg
        self.device = video.device
        self.e_cap = cfg.graph.edge_capacity
        self.i_cap = cfg.graph.inactive_capacity
        h8, w8 = video.h8, video.w8
        self.ii = np.zeros(0, dtype=np.int64)
        self.jj = np.zeros(0, dtype=np.int64)
        self.age = np.zeros(0, dtype=np.int64)
        self.ii_inac = np.zeros(0, dtype=np.int64)
        self.jj_inac = np.zeros(0, dtype=np.int64)
        self.edges = EdgeArrays(self.e_cap, h8, w8, self.device)
        self.t_inac = torch.zeros((self.i_cap, h8, w8, 2), dtype=torch.float32, device=self.device)
        self.w_inac = torch.zeros((self.i_cap, h8, w8, 2), dtype=torch.float32, device=self.device)
        self._step = UpdateStep(cfg, update_fn)
        self._host_pack_dev = None
        self._host_pack_np = None
        self._host_pack_t1 = -1
        self._prox_offset = 1
        self._perm = np.arange(self.e_cap, dtype=np.int64)
        self._is_new = np.zeros(self.e_cap, dtype=bool)
        self._dirty = False

    # ------------------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.ii)

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _padded(self, arr, cap: int) -> torch.Tensor:
        out = np.zeros(cap, dtype=np.int64)
        out[: len(arr)] = arr
        return self._dev(out)

    # ------------------------------------------------------------------
    def add_factors(self, ii_new, jj_new, remove: bool = False):
        """Dedup, enforce the budget, and initialize new edges
        (covisible_graph.py:103-149)."""
        ii_new = np.asarray(ii_new, dtype=np.int64)
        jj_new = np.asarray(jj_new, dtype=np.int64)
        existing = set(zip(self.ii.tolist(), self.jj.tolist())) | set(
            zip(self.ii_inac.tolist(), self.jj_inac.tolist()))
        keep, seen = [], set()
        for k, (a, b) in enumerate(zip(ii_new.tolist(), jj_new.tolist())):
            if (a, b) not in existing and (a, b) not in seen:
                keep.append(k)
                seen.add((a, b))
        if not keep:
            return
        ii_new, jj_new = ii_new[keep], jj_new[keep]

        budget = self.cfg.graph.max_factors
        if remove and budget > 0 and self.n + len(ii_new) > budget and self.n > 0:
            # evict the oldest edges beyond the budget, stable by slot
            order = np.argsort(self.age, kind="stable")
            ranks = np.empty(self.n, dtype=np.int64)
            ranks[order] = np.arange(self.n)
            self.rm_factors(ranks >= max(budget - len(ii_new), 0), store=True)

        m = len(ii_new)
        if self.n + m > self.e_cap:
            m = self.e_cap - self.n
            ii_new, jj_new = ii_new[:m], jj_new[:m]
            if m <= 0:
                return
        n_old = self.n
        self.ii = np.concatenate([self.ii, ii_new])
        self.jj = np.concatenate([self.jj, jj_new])
        self.age = np.concatenate([self.age, np.zeros(m, dtype=np.int64)])
        self._is_new[n_old:n_old + m] = True
        self._dirty = True

    def _queue_perm(self, keep_idx: np.ndarray):
        nk = len(keep_idx)
        new_perm = np.arange(self.e_cap, dtype=np.int64)
        new_is_new = np.zeros(self.e_cap, dtype=bool)
        new_perm[:nk] = self._perm[keep_idx]
        new_is_new[:nk] = self._is_new[keep_idx]
        self._perm = new_perm
        self._is_new = new_is_new
        self._dirty = True

    def _flush(self):
        """Apply the pending membership change as one gather: surviving
        edges move to compact slots, new ones start from nets[ii], the
        reprojection and zero weight (covisible_graph.py:124-149)."""
        if not self._dirty:
            return
        e = self.edges
        perm = self._dev(np.clip(self._perm, 0, self.e_cap - 1))
        is_new = self._dev(self._is_new)[:, None, None, None]
        ii, jj = self._padded(self.ii, self.e_cap), self._padded(self.jj, self.e_cap)
        v = self.video
        coords, _ = pj.projective_transform(v.poses, v.disps, v.intrinsics, ii, jj)
        e.net.copy_(torch.where(is_new, v.nets[ii], e.net[perm]))
        e.target.copy_(torch.where(is_new, coords, e.target[perm]))
        e.weight.copy_(torch.where(is_new, torch.zeros((), device=self.device), e.weight[perm]))
        self._perm = np.arange(self.e_cap, dtype=np.int64)
        self._is_new[:] = False
        self._dirty = False

    def _rebuild_inactive(self, perm_old, from_active, act_idx):
        """Compact the inactive store, absorbing retired active edges."""
        po = self._dev(np.clip(perm_old, 0, self.i_cap - 1))
        pa = self._dev(np.clip(act_idx, 0, self.e_cap - 1))
        sel = self._dev(from_active)[:, None, None, None]
        t_new = torch.where(sel, self.edges.target[pa], self.t_inac[po])
        w_new = torch.where(sel, self.edges.weight[pa], self.w_inac[po])
        self.t_inac.copy_(t_new)
        self.w_inac.copy_(w_new)

    def _compact_inactive(self, keep: np.ndarray):
        self.ii_inac = self.ii_inac[keep]
        self.jj_inac = self.jj_inac[keep]
        perm_old = np.zeros(self.i_cap, dtype=np.int64)
        perm_old[: len(keep)] = keep
        self._rebuild_inactive(perm_old, np.zeros(self.i_cap, bool), np.zeros(self.i_cap, np.int64))

    # ------------------------------------------------------------------
    def rm_factors(self, mask: np.ndarray, store: bool = False):
        """Drop masked active edges, optionally retiring them to the
        inactive store (covisible_graph.py:152-176)."""
        mask = np.asarray(mask, dtype=bool)
        if mask.sum() == 0:
            return
        drop_idx = np.nonzero(mask)[0]
        keep_idx = np.nonzero(~mask)[0]
        if store and np.any(self._is_new[drop_idx]):
            self._flush()
        if store:
            n_i = len(self.ii_inac)
            n_add = len(drop_idx)
            overflow = max(0, n_i + n_add - self.i_cap)
            old_keep = np.arange(overflow, n_i)
            self.ii_inac = np.concatenate([self.ii_inac[old_keep], self.ii[drop_idx]])
            self.jj_inac = np.concatenate([self.jj_inac[old_keep], self.jj[drop_idx]])
            perm_old = np.zeros(self.i_cap, dtype=np.int64)
            from_act = np.zeros(self.i_cap, dtype=bool)
            act_idx = np.zeros(self.i_cap, dtype=np.int64)
            nk = len(old_keep)
            perm_old[:nk] = old_keep
            from_act[nk:nk + n_add] = True
            act_idx[nk:nk + n_add] = self._perm[drop_idx]
            self._rebuild_inactive(perm_old, from_act, act_idx)
        self.ii = self.ii[keep_idx]
        self.jj = self.jj[keep_idx]
        self.age = self.age[keep_idx]
        self._queue_perm(keep_idx)

    def rm_keyframe(self, ix: int):
        """Remove keyframe ix and re-index every edge store
        (covisible_graph.py:180-211)."""
        self.video.rm_keyframe(ix)
        m = (self.ii_inac == ix) | (self.jj_inac == ix)
        self.ii_inac = np.where(self.ii_inac >= ix, self.ii_inac - 1, self.ii_inac)
        self.jj_inac = np.where(self.jj_inac >= ix, self.jj_inac - 1, self.jj_inac)
        if m.any():
            self._compact_inactive(np.nonzero(~m)[0])
        m = (self.ii == ix) | (self.jj == ix)
        self.ii = np.where(self.ii >= ix, self.ii - 1, self.ii)
        self.jj = np.where(self.jj >= ix, self.jj - 1, self.jj)
        self.rm_factors(m, store=False)

    def shift_indices(self, roll: int):
        """Rollup re-indexing (dbaf_frontend.py:106-114)."""
        self.ii -= roll
        self.jj -= roll
        self.ii_inac -= roll
        self.jj_inac -= roll
        keep = np.nonzero((self.ii_inac >= 0) & (self.jj_inac >= 0))[0]
        if len(keep) != len(self.ii_inac):
            self._compact_inactive(keep)

    # ------------------------------------------------------------------
    def _run(self, t0: int, t1: int, iters: int, use_inactive: bool, rounds: int, rounds_b: int,
             mega: bool) -> UpdateResult:
        s0 = max(0, t1 - self.cfg.ba.window)
        e_mask = np.zeros(self.e_cap, dtype=bool)
        e_mask[: self.n] = True
        i_mask = np.zeros(self.i_cap, dtype=bool)
        i_mask[: len(self.ii_inac)] = True
        res = self._step(
            self.video, self.edges,
            self._padded(self.ii, self.e_cap), self._padded(self.jj, self.e_cap), self._dev(e_mask),
            self.t_inac, self.w_inac,
            self._padded(self.ii_inac, self.i_cap), self._padded(self.jj_inac, self.i_cap),
            self._dev(i_mask), t0, t1, s0, rounds, rounds_b, iters,
            use_inactive, mega)
        self._host_pack_dev = res.host_pack
        self._host_pack_np = None
        return res

    def update(self, t0: Optional[int] = None, t1: Optional[int] = None, iters: int = 2,
               use_inactive: bool = False, rounds: int = 1):
        """``rounds`` update rounds (covisible_graph.py:213-342 per round)."""
        if self.n == 0:
            return
        if t0 is None:
            t0 = max(1, int(self.ii.min()) + 1)
        if t1 is None:
            t1 = int(max(self.ii.max(), self.jj.max())) + 1
        self._flush()
        self._run(t0, t1, iters, use_inactive, rounds, 0, mega=False)
        self._host_pack_t1 = t1
        self._prox_offset = 1
        self.age += rounds

    def update_mega(self, rounds_a: int, rounds_b: int, iters: int = 2):
        """The fused visual keyframe step: rounds_a rounds, the cull
        decision, then rounds_b rounds + seeding unless culled.  Returns
        (culled, cull_distance, trajectory row on the device)."""
        self._flush()
        t0 = max(1, int(self.ii.min()) + 1)
        t1 = int(max(self.ii.max(), self.jj.max())) + 1
        res = self._run(t0, t1, iters, True, rounds_a, rounds_b, mega=True)
        self._prox_offset = 2
        pack = self.host_pack
        culled = bool(pack[0] > 0.5)
        if culled:
            self._host_pack_t1 = -(10 ** 6)  # prox entries predate the shift
            self.age += rounds_a
        else:
            self._host_pack_t1 = t1
            self.age += rounds_a + rounds_b
        return culled, float(pack[1]), res.traj_row

    @property
    def host_pack(self) -> Optional[np.ndarray]:
        if self._host_pack_dev is None:
            return None
        if self._host_pack_np is None:
            self._host_pack_np = self._host_pack_dev.cpu().numpy()
        return self._host_pack_np

    # ------------------------------------------------------------------
    def add_neighborhood_factors(self, t0: int, t1: int, r: int = 3):
        """Dense all-pairs edges within radius r (covisible_graph.py:344-354)."""
        ii, jj = np.meshgrid(np.arange(t0, t1), np.arange(t0, t1), indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        keep = (np.abs(ii - jj) > 0) & (np.abs(ii - jj) <= r)
        self.add_factors(ii[keep], jj[keep])

    def _candidate_distances(self, t0, t1, t, ii, jj, beta) -> np.ndarray:
        """Proximity distances: the values the last update step computed on
        its end state when they match this query, else fresh ones."""
        pack = self.host_pack
        wf = self.cfg.graph.frontend_window
        n_skip = len(self.cfg.graph.skip_edge) if wf == 5 else 0
        expected = 5 * wf + n_skip
        off = self._prox_offset
        if (pack is not None and self._host_pack_t1 + 1 == t and t0 == t - 5
                and t1 == t - wf and len(ii) == expected):
            return pack[off:off + expected].astype(np.float64).copy()
        return self.video.distance(ii, jj, beta=beta).astype(np.float64)

    def add_proximity_factors(self, t0: int = 0, t1: int = 0, rad: int = 2, nms: int = 2,
                              beta: float = 0.25, thresh: float = 16.0, remove: bool = False):
        """Distance-ranked edge selection with NMS, forced radius edges and
        the opportunistic skip edge (covisible_graph.py:357-441), run by the
        native scheduler ``native/graphops.cpp``."""
        t = self.video.counter
        ix = np.arange(t0, t)
        jx = np.arange(t1, t)
        if len(ix) == 0 or len(jx) == 0:
            return
        ii, jj = np.meshgrid(ix, jx, indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        cc = ii.shape[0]
        skip = list(self.cfg.graph.skip_edge)
        if skip and (ii.max() - ii.min() == self.cfg.graph.frontend_window - 1):
            jj_add = ii.min() + np.asarray(skip, dtype=np.int64)
            jj_add = jj_add[jj_add > 0]
            ii = np.concatenate([ii, np.full_like(jj_add, ii.max())])
            jj = np.concatenate([jj, jj_add])
        d = self._candidate_distances(t0, t1, t, ii, jj, beta)
        ii_new, jj_new = select_proximity_edges(
            d, ii, jj, cc,
            np.concatenate([self.ii, self.ii_inac]),
            np.concatenate([self.jj, self.jj_inac]),
            t0, t1, t, rad, nms, thresh, self.cfg.graph.max_factors)
        if len(ii_new):
            self.add_factors(ii_new, jj_new, remove)


def select_proximity_edges(d, ii, jj, cc, exist_ii, exist_jj, t0, t1, t, rad, nms, thresh,
                           max_factors):
    """Run the native edge scheduler; returns (ii_out, jj_out) in its order."""
    import ctypes

    from ..utils.cuda_build import load_graphops

    lib = load_graphops()
    lp = ctypes.POINTER(ctypes.c_long)
    d = np.ascontiguousarray(d, dtype=np.float64)
    ii = np.ascontiguousarray(ii, dtype=np.int64)
    jj = np.ascontiguousarray(jj, dtype=np.int64)
    exist_ii = np.ascontiguousarray(exist_ii, dtype=np.int64)
    exist_jj = np.ascontiguousarray(exist_jj, dtype=np.int64)
    max_out = 4 * (max_factors + 4 * (t - t0) * (rad + 2) + 8)
    out_ii = np.empty(max_out, dtype=np.int64)
    out_jj = np.empty(max_out, dtype=np.int64)
    n = lib.select_proximity_edges(
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ii.ctypes.data_as(lp), jj.ctypes.data_as(lp), len(ii), cc,
        exist_ii.ctypes.data_as(lp), exist_jj.ctypes.data_as(lp), len(exist_ii),
        t0, t1, t, rad, nms, float(thresh), max_factors,
        out_ii.ctypes.data_as(lp), out_jj.ctypes.data_as(lp), max_out)
    return out_ii[:n], out_jj[:n]
