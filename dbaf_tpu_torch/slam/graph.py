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
the CPU (and that ``tests/data/golden_trace.npz`` recorded).  With
``cfg.graph.corr_int8`` every round runs K1-int8 (``corr_fused_xy_int8``;
its plain version on the CPU) where the feature grid holds whole int8 tiles.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops import corr as corr_ops
from ..ops import corr_cuda
from ..ops import dba, lie
from ..ops import projective as pj
from ..train.unroll import upsample_disp
from ..utils.config import DBAFusionConfig
from ..utils.device import FlagPoll, clip, device_const, rows_at, set_row, to_host, upload
from ..utils.profiling import TRACER
from .video import DepthVideo


BAD_CAP = 64  # the asynchronous steps' quarantined-edge store (CovisibleGraph.filter_edges)

# the edge stores' device carry (CovisibleGraph.carry), the integers a drain reads back
EDGE_CARRY = ("ii", "jj", "age", "e_valid", "ii_i", "jj_i", "i_valid", "bad_ii", "bad_jj",
              "bad_valid")


class UpdateResult(NamedTuple):
    host_pack: torch.Tensor  # [cull..., prox dists...] on the device
    traj_row: Optional[torch.Tensor]  # camera-to-world 7-vec (mega step)


class StepFields(NamedTuple):
    """A keyframe step's packed results by name; None where its layout has
    no such field."""
    cull: Any = None   # 1.0 where the keyframe culls
    d: Any = None      # the cull flow distance
    prox: Any = None   # the next keyframe's proximity candidate distances
    hyst: Any = None   # (7,) translation-hysteresis norms (coupled)
    rows: Any = None   # (NW, 21) solved window state (coupled)
    pose: Any = None   # [R(9)|t(3)] body pose of the new keyframe after rounds_a (coupled)
    t0: Any = None     # the window origin (coupled)


def metrics_fields(x) -> StepFields:
    """:meth:`UpdateStep.host_metrics`' pack: [d, prox...]."""
    return StepFields(d=x[0], prox=x[1:])


def mega_fields(x) -> StepFields:
    """:meth:`UpdateStep.mega`'s pack: [cull, d, prox...]."""
    return StepFields(cull=x[0], d=x[1], prox=x[2:])


def prox_fields(x) -> StepFields:
    """A pipeline's carried proximity distances alone."""
    return StepFields(prox=x)


class StepPack:
    """A step's packed results on the device, cut into :class:`StepFields`
    by ``layout`` (which slices the device tensor, as views, and its host
    copy alike); the host copy is read once, on first use."""

    def __init__(self, dev: torch.Tensor, layout: Callable[..., StepFields]):
        self.dev = dev
        self.layout = layout
        self._host = None

    def on_device(self) -> StepFields:
        return self.layout(self.dev)

    def on_host(self) -> StepFields:
        if self._host is None:
            self._host = self.layout(to_host(self.dev))
        return self._host


def n_prox(cfg: DBAFusionConfig) -> int:
    """The number of proximity candidate distances a step computes for the
    next keyframe (:meth:`UpdateStep.host_metrics`)."""
    wf = cfg.graph.frontend_window
    return 5 * wf + (len(cfg.graph.skip_edge) if wf == 5 else 0)


def padded(arr, cap: int) -> np.ndarray:
    """The first ``cap`` entries of an int64 array, zero-padded to ``cap``."""
    out = np.zeros(cap, dtype=np.int64)
    n = min(len(arr), cap)
    out[:n] = arr[:n]
    return out


def read_ints(st: dict, names) -> dict:
    """The integer and bool tensors ``names`` of ``st`` as int64 host
    arrays, flattened, in one read."""
    flat = to_host(torch.cat([st[k].reshape(-1).to(torch.int64) for k in names]))
    ends = np.cumsum([st[k].numel() for k in names])
    return {k: flat[e - st[k].numel():e] for k, e in zip(names, ends)}


def edge_confidence(weight: torch.Tensor) -> torch.Tensor:
    """Mean confidence of each edge row of an (E, H, W, 2) weight store
    (dbaf_tpu/slam/graph.py:358)."""
    return weight.mean(dim=(1, 2, 3))


def corr_operands(cfg: DBAFusionConfig, video, ii: torch.Tensor, jj: torch.Tensor,
                  right: bool = True):
    """Round-invariant correlation operands of an edge set: the prepared
    bf16 features and the int8 tile (None: bf16) for K1 or K1-int8, or the
    bf16 volume for ``lookup_fused`` on the CPU without int8.  With a stereo
    rig's right buffer (and ``right``), a self-edge (``ii == jj``)
    correlates the left features with the right camera's
    (dbaf_tpu/slam/graph.py:100-118).  The features are the video's rows
    (``feature_rows``: gathered from their ranks under ``shard_video``)."""
    E = ii.shape[0]
    f = video.feature_rows("fmaps", torch.cat([ii, jj]))
    f1, f2 = f[:E], f[E:]
    if right and video.fmaps_right is not None:
        f2 = torch.where((ii == jj)[:, None, None, None], video.feature_rows("fmaps_right", jj),
                         f2)
    tile = None
    if cfg.graph.corr_int8:
        tile = corr_cuda.int8_tile(f1.shape[1], f1.shape[2], cfg.graph.corr_group)
    if f1.is_cuda or tile is not None:
        return corr_cuda.prepare_corr_fmaps(f1, f2) + (tile,)
    return (corr_ops.build_volume_nhwc(f1, f2),)


def round_weights(w_all: torch.Tensor, ii: torch.Tensor, jj: torch.Tensor, mask: torch.Tensor,
                  poses: torch.Tensor, disps: torch.Tensor, imu: bool, mask_threshold: float,
                  far_threshold: float):
    """The BA weights of a round's edges from the update operator's
    ``w_all`` (E, H, W, 2), the confidence heuristics of
    covisible_graph.py:309-328: x0.1 on the edges out of the newest source
    frame and x0.25 on those into the newest target frame (among the valid
    edges, ``mask``); with ``imu``, x1e-3 on the edges whose frames lie
    less than ``mask_threshold`` apart (where it is positive) and on the
    pixels of disparity below ``far_threshold`` (where it is positive).
    Returns (the weights, the short-baseline mask's flags over the edges or
    None where it does not apply)."""
    neg = torch.full_like(ii, -1)
    max_i = torch.max(torch.where(mask, ii, neg))
    max_j = torch.max(torch.where(mask, jj, neg))
    wmul = torch.where(ii == max_i, 0.1, 1.0) * torch.where(jj == max_j, 0.25, 1.0)
    cut = None
    if mask_threshold > 0 and imu:
        tnorm = torch.linalg.norm(lie.se3_rel(poses[jj], poses[ii])[:, :3], dim=-1)
        cut = tnorm < mask_threshold
        wmul = wmul * torch.where(cut, 1e-3, 1.0)
    w_ba = w_all * wmul.to(torch.float32)[:, None, None, None]
    if far_threshold > 0 and imu:
        pixmask = (disps[ii] < far_threshold)[..., None]
        w_ba = torch.where(pixmask, w_ba * 1e-3, w_ba)
    return w_ba, cut


def corr_round(prep, coords1: torch.Tensor, whole: bool = False) -> torch.Tensor:
    """(E, H, W, 196) correlation features of one round; ``whole``: the
    pyramid's levels pool whole blocks only (``cfg.corr_whole_blocks``)."""
    if len(prep) == 3:
        f1p, f2p, tile = prep
        H2, W2 = coords1.shape[1], coords1.shape[2]
        if tile is None:
            return corr_cuda.corr_fused_xy(f1p, f2p, coords1, H2, W2, whole=whole)
        return corr_cuda.corr_fused_xy_int8(f1p, f2p, coords1, H2, W2, tile)
    (vol,) = prep
    return corr_ops.lookup_fused(vol, coords1, whole=whole).permute(0, 2, 3, 1)


class EdgeSets(NamedTuple):
    """The edges one step solves over: inactive then active rows (device
    tensors) and the same rows on the host, for the coupled solve."""
    ii: torch.Tensor
    jj: torch.Tensor
    mask: torch.Tensor
    ii_np: np.ndarray
    jj_np: np.ndarray
    mask_np: np.ndarray


class MegaPolls(NamedTuple):
    """The reads of a fused visual step's gates: the frame's admission
    (every round) and admission without a cull (rounds_b)."""
    run: FlagPoll
    rounds_b: FlagPoll


def blocking_mega_polls() -> MegaPolls:
    """The synchronous flow's polls: each post is one host read."""
    return MegaPolls(FlagPoll(blocking=True), FlagPoll(blocking=True))


class UpdateStep:
    """The fused update step (``make_update_kernel``): the visual ``do_ba``
    path (mega and per-round variants) and, through :meth:`update_round`,
    the rounds of the coupled step (slam/coupled_fused.py).

    ``update_fn(net, inp, corr, motn, ii, jj, aux) -> (net, delta, weight)``
    is the update operator (or a test oracle); ``aux`` is the graph's
    ``aux`` dict extended by this round's ``coords1``, ``poses`` and
    ``disps``."""

    def __init__(self, cfg: DBAFusionConfig, update_fn: Callable):
        self.cfg = cfg
        self.update_fn = update_fn

    def edge_sets(self, ii, jj, e_mask, ii_i, jj_i, i_mask, t0: int, use_inactive: bool,
                  device: torch.device) -> EdgeSets:
        """Active edges, preceded by the inactive ones still in range
        (``inac_range``) when ``use_inactive``.  Index arguments are host
        int64 arrays (the masks bool)."""
        if use_inactive:
            inac = self.cfg.graph.inac_range
            keep_i = i_mask & (ii_i >= t0 - inac) & (jj_i >= t0 - inac)
            ii_np = np.concatenate([ii_i, ii])
            jj_np = np.concatenate([jj_i, jj])
            m_np = np.concatenate([keep_i, e_mask])
        else:
            ii_np, jj_np, m_np = ii, jj, e_mask
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        return EdgeSets(t(ii_np), t(jj_np), t(m_np), ii_np, jj_np, m_np)

    def edge_sets_device(self, ii, jj, e_mask, ii_i, jj_i, i_mask, t0) -> EdgeSets:
        """:meth:`edge_sets` with ``use_inactive`` on device tensors (``t0``
        an int or a 0-d tensor), with no host view."""
        inac = self.cfg.graph.inac_range
        keep_i = i_mask & (ii_i >= t0 - inac) & (jj_i >= t0 - inac)
        return EdgeSets(torch.cat([ii_i, ii]), torch.cat([jj_i, jj]), torch.cat([keep_i, e_mask]),
                        None, None, None)

    def update_round(self, video: DepthVideo, edges, ii, jj, e_mask, t_inac, w_inac,
                     sets: EdgeSets, prep, inp_e, aux: dict, use_inactive: bool):
        """Reprojection -> correlation -> update operator -> confidence
        heuristics (covisible_graph.py:213-328).  Edge state is written in
        place; returns the BA inputs (t_all, w_ba) over ``sets``."""
        cfg = self.cfg
        dev = video.poses.device
        poses, disps, intrinsics = video.poses, video.disps, video.intrinsics
        m4 = e_mask[:, None, None, None]
        grid = pj.coords_grid(video.h8, video.w8, device=dev)
        coords1, _ = pj.projective_transform(poses, disps, intrinsics, ii, jj)
        motn = torch.cat([coords1 - grid, edges.target - coords1], dim=-1).clamp(-64.0, 64.0)
        corr = corr_round(prep, coords1, cfg.corr_whole_blocks)
        net_dt = edges.net.dtype
        aux_full = dict(aux)
        aux_full.update(coords1=coords1, poses=poses, disps=disps)
        net_new, delta, weight_up = self.update_fn(
            edges.net, inp_e.to(net_dt), corr.to(net_dt), motn.to(net_dt), ii, jj, aux_full)
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

        w_ba, cut = round_weights(w_all, sets.ii, sets.jj, sets.mask, poses, disps,
                                  video.imu_enabled, cfg.graph.mask_threshold,
                                  cfg.graph.far_threshold)
        if TRACER.on and cut is not None:  # the active edges are the sets' last
            TRACER.add_masked((cut & sets.mask)[-ii.shape[0]:])
        return t_all, w_ba

    def window_ba(self, video: DepthVideo, t_all, w_ba, sets: EdgeSets, t0, t1, s0, iters: int):
        """Window-local dense BA over [s0, s0 + window), in place, with the
        depth sensor's prior (weight ``cfg.ba.alpha``) once ``video`` holds a
        depth frame.  ``t0``, ``t1`` and ``s0`` are ints or 0-d device
        tensors."""
        cfg = self.cfg
        P = cfg.ba.window
        B = video.poses.shape[0]
        # window start as jax.lax.dynamic_slice clamps it (s0 = t1 - P keeps
        # it inside the buffer)
        rows = torch.arange(P, device=video.poses.device) + clip(s0, 0, B - P)
        poses_w, disps_w, damping_w = (b.index_select(0, rows) for b in (
            video.poses, video.disps, video.damping))
        use_sens = video.has_depth
        sens_w = video.disps_sens.index_select(0, rows) if use_sens else None
        eta = 0.2 * damping_w.reshape(P, -1) + cfg.ba.eps_damping
        m_ba = sets.mask & (sets.ii >= s0) & (sets.jj >= s0)
        ii_w = torch.clamp(sets.ii - s0, 0, P - 1)
        jj_w = torch.clamp(sets.jj - s0, 0, P - 1)
        state = dba.ba(poses_w, disps_w, video.intrinsics, t_all, w_ba, eta, ii_w, jj_w, m_ba,
                       t0 - s0, t1 - s0, disps_sens=sens_w, iterations=iters, lm=cfg.ba.lm,
                       ep=cfg.ba.ep, alpha=cfg.ba.alpha, use_sens=use_sens)
        video.poses.index_copy_(0, rows, state.poses)
        video.disps.index_copy_(0, rows, state.disps)

    def __call__(self, video: DepthVideo, edges, ii, jj, e_mask, t_inac, w_inac, ii_i, jj_i,
                 i_mask, t0: int, t1: int, s0: int, rounds: int, rounds_b: int, iters: int,
                 use_inactive: bool, mega: bool, aux: Optional[dict] = None) -> UpdateResult:
        """The visual step, in place on ``video`` (poses, disps) and
        ``edges`` (net, target, weight).  Index arguments are host int64
        arrays (the masks bool)."""
        aux = {} if aux is None else aux
        dev = video.poses.device
        ii, jj, e_mask, ii_i, jj_i, i_mask = (np.asarray(a) for a in (ii, jj, e_mask, ii_i, jj_i,
                                                                       i_mask))
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        ii_t, jj_t, e_mask_t = t(ii), t(jj), t(e_mask)
        sets = self.edge_sets(ii, jj, e_mask, ii_i, jj_i, i_mask, t0, use_inactive, dev)
        if mega:
            pack, traj_row, _, _ = self.mega(video, edges, ii_t, jj_t, e_mask_t, t_inac, w_inac,
                                             sets, t0, t1, s0, rounds, rounds_b, iters, aux)
            return UpdateResult(host_pack=pack, traj_row=traj_row)
        inp_e = video.feature_rows("inps", ii_t)
        prep = corr_operands(self.cfg, video, ii_t, jj_t)
        for _ in range(rounds):
            t_all, w_ba = self.update_round(video, edges, ii_t, jj_t, e_mask_t, t_inac, w_inac,
                                            sets, prep, inp_e, aux, use_inactive)
            self.window_ba(video, t_all, w_ba, sets, t0, t1, s0, iters)
        return UpdateResult(host_pack=self.host_metrics(video, t1), traj_row=None)

    def mega(self, video: DepthVideo, edges, ii, jj, e_mask, t_inac, w_inac, sets: EdgeSets,
             t0, t1, s0, rounds_a: int, rounds_b: int, iters: int, aux: dict,
             run: Optional[torch.Tensor] = None, polls: Optional[MegaPolls] = None):
        """The fused visual keyframe step (``make_update_kernel(...).raw``
        with ``mega=True``, dbaf_frontend.py:243-373): ``rounds_a`` rounds,
        the cull decision on the state after them, ``rounds_b`` more unless
        the keyframe culls, and the next slot seeded unless it culls; in
        place on ``video`` and ``edges``.  Index arguments are device
        tensors over the active edges and ``sets``; ``t0``, ``t1`` and
        ``s0`` ints or 0-d device tensors.

        ``run`` (a 0-d device bool, None for always) gates every round: the
        asynchronous step's frame the motion gate rejected runs none, as the
        JAX step's zero round counts.  Each gate goes to its poll in
        ``polls`` (by default :func:`blocking_mega_polls`, one host read
        each); where the answer is not in yet, the gated rounds run masked
        and their writes are undone where the gate is off.

        Returns (pack [cull, d, prox...] on the device, the trajectory row
        after ``rounds_a``, the cull flag, (rounds_a, rounds_b) rounds run
        masked)."""
        polls = polls or blocking_mega_polls()
        B = video.poses.shape[0]
        inp_e = video.feature_rows("inps", ii)
        prep = corr_operands(self.cfg, video, ii, jj)
        bufs = (video.poses, video.disps, edges.net, edges.target, edges.weight)

        def rounds(n: int, gate: Optional[torch.Tensor], poll: FlagPoll) -> int:
            if n == 0:
                return 0
            known = True
            if gate is not None:
                poll.reset()
                poll.post(gate)
                known = poll.value()
                if known is False:
                    return 0
                saved = None if known else [b.clone() for b in bufs]
            for _ in range(n):
                t_all, w_ba = self.update_round(video, edges, ii, jj, e_mask, t_inac, w_inac, sets,
                                                prep, inp_e, aux, True)
                self.window_ba(video, t_all, w_ba, sets, t0, t1, s0, iters)
            if known:
                return 0
            for buf, old in zip(bufs, saved):
                buf.copy_(torch.where(gate, buf, old))
            return n

        masked_a = rounds(rounds_a, run, polls.run)
        d_cull = self.cull_metric(video, t1)
        if run is not None:
            d_cull = torch.where(run, d_cull, torch.full_like(d_cull, float("inf")))
        traj_row = lie.se3_inv(rows_at(video.poses, clip(t1 - 1, 0, B - 1)))
        cull = d_cull < self.cfg.frontend.keyframe_thresh
        masked_b = rounds(rounds_b, ~cull if run is None else run & ~cull, polls.rounds_b)
        # next-slot seeding unless culled (dbaf_frontend.py:371-373)
        slot = clip(t1, 0, B - 1)
        prev = clip(slot - 1, 0, B - 1)
        for buf, row in ((video.poses, rows_at(video.poses, prev)),
                         (video.disps, rows_at(video.disps, prev).mean().expand(
                             video.disps.shape[1:]))):
            set_row(buf, slot, torch.where(cull, rows_at(buf, slot), row))
        pack = torch.cat([cull.to(torch.float32).reshape(1), d_cull.reshape(1),
                          self.host_metrics(video, t1)[1:]])
        return pack, traj_row, cull, (masked_a, masked_b)

    def cull_metric(self, video: DepthVideo, t1) -> torch.Tensor:
        """Keyframe-cull flow distance (dbaf_frontend.py:264); ``t1`` an int
        or a 0-d device tensor."""
        at = t1 - 3 + torch.arange(2, device=video.poses.device)
        return pj.frame_distance_bidirectional(
            video.poses, video.disps, video.intrinsics, at[:1], at[1:],
            beta=self.cfg.graph.beta)[0]

    def host_metrics(self, video: DepthVideo, t1) -> torch.Tensor:
        """[cull distance, next keyframe's proximity candidate distances],
        computed on the end state with the incoming frame seeded
        (covisible_graph.py:379).  ``t1`` is an int or a 0-d device tensor
        (the asynchronous step's); the candidates are built on the device."""
        cfg = self.cfg
        wf = cfg.graph.frontend_window
        n_skip = len(cfg.graph.skip_edge) if wf == 5 else 0
        poses, disps = video.poses, video.disps
        B = poses.shape[0]
        dev = poses.device
        seed = clip(t1, 0, B - 1)
        poses_x = poses.clone()
        disps_x = disps.clone()
        set_row(poses_x, seed, rows_at(poses, (seed - 1) % B))
        set_row(disps_x, seed, rows_at(disps, (seed - 1) % B).mean().expand(disps.shape[1:]))
        t_next = t1 + 1
        ar = lambda n: torch.arange(n, device=dev)  # noqa: E731
        pi = (t_next - 5 + ar(5))[:, None].expand(5, wf).reshape(-1)
        pj_ = (t_next - wf + ar(wf)).repeat(5)
        if n_skip:
            pi = torch.cat([pi, t_next - 1 + 0 * ar(n_skip)])
            pj_ = torch.cat([pj_, t_next - 5 + device_const(cfg.graph.skip_edge, torch.int64, dev)])
        cand_i = torch.clamp(torch.cat([t1 - 3 + ar(1), pi]), 0, B - 1)
        cand_j = torch.clamp(torch.cat([t1 - 2 + ar(1), pj_]), 0, B - 1)
        return pj.frame_distance_bidirectional(poses_x, disps_x, video.intrinsics, cand_i, cand_j,
                                               beta=cfg.graph.beta)


class EdgeArrays:
    """Per-edge device state: GRU hidden (bf16), target coords, weights."""

    def __init__(self, e_cap: int, h8: int, w8: int, device: torch.device):
        self.net = torch.zeros((e_cap, h8, w8, 128), dtype=torch.bfloat16, device=device)
        self.target = torch.zeros((e_cap, h8, w8, 2), dtype=torch.float32, device=device)
        self.weight = torch.zeros((e_cap, h8, w8, 2), dtype=torch.float32, device=device)

    def assign(self, arrays) -> None:
        """Write (net, target, weight) into the stores in place."""
        for dst, src in zip((self.net, self.target, self.weight), arrays):
            dst.copy_(src)


def _rebuild_edges(edges: EdgeArrays, perm, is_new, ii, jj, poses, disps, intrinsics, nets_e):
    """The edge stores after a membership change, as new tensors
    (dbaf_tpu/slam/graph.py:45): slot ``s`` takes old slot ``perm[s]``
    (clipped), except where ``is_new``, where a new edge starts from
    ``nets_e[s]`` (the keyframe state ``nets[ii[s]]``), its reprojection and
    zero weight (covisible_graph.py:124-149).  perm, is_new, ii, jj:
    (E_CAP,) device tensors."""
    perm = torch.clamp(perm, 0, edges.net.shape[0] - 1)
    coords, _ = pj.projective_transform(poses, disps, intrinsics, ii, jj)
    sel = is_new[:, None, None, None]
    return (torch.where(sel, nets_e.to(edges.net.dtype), edges.net[perm]),
            torch.where(sel, coords, edges.target[perm]),
            torch.where(sel, 0.0, edges.weight[perm]))


def _rebuild_inactive(t_inac, w_inac, perm_old, from_active, act_idx, target, weight):
    """The inactive store compacted and absorbing retired edges, as new
    tensors (dbaf_tpu/slam/graph.py:68): slot ``s`` takes old inactive slot
    ``perm_old[s]``, or active slot ``act_idx[s]`` where ``from_active``."""
    po = torch.clamp(perm_old, 0, t_inac.shape[0] - 1)
    pa = torch.clamp(act_idx, 0, target.shape[0] - 1)
    sel = from_active[:, None, None, None]
    return torch.where(sel, target[pa], t_inac[po]), torch.where(sel, weight[pa], w_inac[po])


class CovisibleGraph:
    """Host-side edge manager around the fused update step."""

    def __init__(self, video: DepthVideo, update_fn: Callable, cfg: DBAFusionConfig):
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
        # quarantined edges (filter_edges): never selected again
        self.ii_bad = np.zeros(0, dtype=np.int64)
        self.jj_bad = np.zeros(0, dtype=np.int64)
        self.edges = EdgeArrays(self.e_cap, h8, w8, self.device)
        self.t_inac = torch.zeros((self.i_cap, h8, w8, 2), dtype=torch.float32, device=self.device)
        self.w_inac = torch.zeros((self.i_cap, h8, w8, 2), dtype=torch.float32, device=self.device)
        self.update_step = UpdateStep(cfg, update_fn)
        self.pack: Optional[StepPack] = None  # the last step's packed results
        # (keyframe count, StepPack): the proximity distances the next
        # selection may reuse (set_prox)
        self.prox = (None, None)
        self.aux = {}               # forwarded to update_fn each round
        self.agg_fn = None          # GraphAgg head of the upsample path
        self.coupled = None         # MultiSensorBA when multi-sensor fusion is on
        self.mega_count = 0         # fused coupled keyframe steps taken
        self.lm_stats = None        # realized LM iterations per coupled round
        self.drop_pending()

    # ------------------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.ii)

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

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

    def flush(self):
        """Apply the pending membership change as one gather: surviving
        edges move to compact slots, new ones start from nets[ii], the
        reprojection and zero weight (covisible_graph.py:124-149)."""
        if not self._dirty:
            return
        v = self.video
        ii = self._dev(padded(self.ii, self.e_cap))
        self.edges.assign(_rebuild_edges(
            self.edges, self._dev(self._perm), self._dev(self._is_new), ii,
            self._dev(padded(self.jj, self.e_cap)), v.poses, v.disps, v.intrinsics,
            v.feature_rows("nets", ii)))
        self.drop_pending()

    def drop_pending(self):
        """Forget the pending membership change (the device stores hold the
        host's edges slot for slot)."""
        self._perm = np.arange(self.e_cap, dtype=np.int64)
        self._is_new = np.zeros(self.e_cap, dtype=bool)
        self._dirty = False

    # ------------------------------------------------------------------
    def carry(self, t1: int) -> dict:
        """The padded device carry both asynchronous pipelines start from:
        the edge stores (``EDGE_CARRY``; the first ``BAD_CAP`` quarantined)
        and ``prox_d``, the proximity distances for keyframe count ``t1``."""
        self.flush()
        E, I = self.e_cap, self.i_cap
        up = lambda a: upload(a, self.device)  # noqa: E731
        p_t1, pack = self.prox
        if p_t1 == t1:
            prox_d = pack.on_device().prox.float().clone()
        else:
            prox_d = metrics_fields(self.update_step.host_metrics(self.video, t1)).prox
        return dict(
            ii=up(padded(self.ii, E)), jj=up(padded(self.jj, E)), age=up(padded(self.age, E)),
            e_valid=up(np.arange(E) < self.n), ii_i=up(padded(self.ii_inac, I)),
            jj_i=up(padded(self.jj_inac, I)), i_valid=up(np.arange(I) < len(self.ii_inac)),
            bad_ii=up(padded(self.ii_bad, BAD_CAP)), bad_jj=up(padded(self.jj_bad, BAD_CAP)),
            bad_valid=up(np.arange(BAD_CAP) < min(len(self.ii_bad), BAD_CAP)), prox_d=prox_d)

    def restore(self, h: dict):
        """Take back the edge stores from a drain's host copies of
        ``EDGE_CARRY`` (:func:`read_ints`); nothing is pending after it."""
        n, ni, nb = (int(h[k].sum()) for k in ("e_valid", "i_valid", "bad_valid"))
        self.ii, self.jj, self.age = h["ii"][:n], h["jj"][:n], h["age"][:n]
        self.ii_inac, self.jj_inac = h["ii_i"][:ni], h["jj_i"][:ni]
        self.ii_bad, self.jj_bad = h["bad_ii"][:nb], h["bad_jj"][:nb]
        self.drop_pending()

    def set_prox(self, t1: Optional[int], pack: Optional[StepPack] = None):
        """The proximity distances the next selection may reuse: those of
        ``pack`` (by default the ones held), computed for keyframe count
        ``t1``; None once they predate a shift."""
        self.prox = (t1, self.prox[1] if pack is None else pack)

    def _rebuild_inactive(self, perm_old, from_active, act_idx):
        """Compact the inactive store, absorbing retired active edges."""
        t_new, w_new = _rebuild_inactive(self.t_inac, self.w_inac, self._dev(perm_old),
                                         self._dev(from_active), self._dev(act_idx),
                                         self.edges.target, self.edges.weight)
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
            self.flush()
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

    @property
    def last_conf(self) -> np.ndarray:
        """The mean confidence of each edge row, as the last update left the
        weights (one host read)."""
        return to_host(edge_confidence(self.edges.weight))

    def filter_edges(self):
        """Quarantine low-confidence long-range edges (covisible_graph.py:88-95):
        they leave the graph and seed the proximity selection's suppression
        from then on.  As in the reference, no path calls it."""
        conf = self.last_conf[:self.n]
        mask = (np.abs(self.ii - self.jj) > 2) & (conf < 0.001)
        if mask.any():
            self.ii_bad = np.concatenate([self.ii_bad, self.ii[mask]])
            self.jj_bad = np.concatenate([self.jj_bad, self.jj[mask]])
            self.rm_factors(mask, store=False)

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
        self.ii_bad = self.ii_bad - roll
        self.jj_bad = self.jj_bad - roll
        bad_keep = (self.ii_bad >= 0) & (self.jj_bad >= 0)
        self.ii_bad, self.jj_bad = self.ii_bad[bad_keep], self.jj_bad[bad_keep]
        # the coupled state keys frames by index: an active edge left below 0
        # would silently corrupt it (the config must keep rollup_start -
        # rollup_shift >= active_window)
        if self.coupled is not None and len(self.ii) and (
                int(self.ii.min()) < 0 or int(self.jj.min()) < 0):
            raise ValueError(
                "rollup left active edges with negative indices -- config violates "
                "rollup_start - rollup_shift >= active_window "
                f"(min ii={int(self.ii.min())}, min jj={int(self.jj.min())})")

    # ------------------------------------------------------------------
    def _masks(self):
        e_mask = np.zeros(self.e_cap, dtype=bool)
        e_mask[: self.n] = True
        i_mask = np.zeros(self.i_cap, dtype=bool)
        i_mask[: len(self.ii_inac)] = True
        return e_mask, i_mask

    def _run(self, t0: int, t1: int, iters: int, use_inactive: bool, rounds: int, rounds_b: int,
             mega: bool) -> UpdateResult:
        s0 = max(0, t1 - self.cfg.ba.window)
        e_mask, i_mask = self._masks()
        res = self.update_step(
            self.video, self.edges, padded(self.ii, self.e_cap), padded(self.jj, self.e_cap),
            e_mask, self.t_inac, self.w_inac, padded(self.ii_inac, self.i_cap),
            padded(self.jj_inac, self.i_cap), i_mask, t0, t1, s0, rounds, rounds_b, iters,
            use_inactive, mega, self.aux)
        self.pack = StepPack(res.host_pack, mega_fields if mega else metrics_fields)
        return res

    def update(self, t0: Optional[int] = None, t1: Optional[int] = None, iters: int = 2,
               use_inactive: bool = False, rounds: int = 1):
        """``rounds`` update rounds (covisible_graph.py:213-342 per round);
        in coupled mode each round's BA is the multi-sensor solve."""
        if self.n == 0:
            return
        if t0 is None:
            t0 = max(1, int(self.ii.min()) + 1)
        if t1 is None:
            t1 = int(max(self.ii.max(), self.jj.max())) + 1
        self.flush()
        if self.video.imu_enabled and self.coupled is not None:
            self._update_coupled(t0, t1, iters, use_inactive, rounds)
        else:
            self._run(t0, t1, iters, use_inactive, rounds, 0, mega=False)
        self.set_prox(t1, self.pack)
        self.age += rounds

    def _update_coupled(self, t0: int, t1: int, iters: int, use_inactive: bool, rounds: int):
        """Coupled rounds: the fused device step, or per round an update
        followed by the host/device multi-sensor call (coupled.ba)."""
        s0 = max(0, t1 - self.cfg.ba.window)
        if self.cfg.sensors.device_solver and self._update_coupled_fused(
                rounds, 0, iters, use_inactive, t0, t1, s0) is not None:
            return
        step = self.update_step
        dev = self.device
        e_mask, i_mask = self._masks()
        ii, jj = padded(self.ii, self.e_cap), padded(self.jj, self.e_cap)
        sets = step.edge_sets(ii, jj, e_mask, padded(self.ii_inac, self.i_cap),
                              padded(self.jj_inac, self.i_cap), i_mask, t0, use_inactive, dev)
        ii_t, jj_t = torch.as_tensor(ii, device=dev), torch.as_tensor(jj, device=dev)
        prep = corr_operands(self.cfg, self.video, ii_t, jj_t)
        inp_e = self.video.feature_rows("inps", ii_t)
        for r in range(rounds):
            t_all, w_ba = step.update_round(self.video, self.edges, ii_t, jj_t,
                                            torch.as_tensor(e_mask, device=dev), self.t_inac,
                                            self.w_inac, sets, prep, inp_e, self.aux,
                                            use_inactive)
            self.pack = StepPack(step.host_metrics(self.video, t1), metrics_fields)
            self.coupled.ba(sets.ii_np, sets.jj_np, sets.mask_np, t_all, w_ba, t1, itrs=iters,
                            reuse_state=r > 0)
        self.coupled.sync_host()

    def update_mega(self, rounds_a: int, rounds_b: int, iters: int = 2):
        """The fused visual keyframe step: rounds_a rounds, the cull
        decision, then rounds_b rounds + seeding unless culled.  Returns
        (culled, cull_distance, trajectory row on the device)."""
        self.flush()
        t0 = max(1, int(self.ii.min()) + 1)
        t1 = int(max(self.ii.max(), self.jj.max())) + 1
        res = self._run(t0, t1, iters, True, rounds_a, rounds_b, mega=True)
        f = self.host_pack
        culled = bool(f.cull > 0.5)
        # a cull's distances predate the shift
        self.set_prox(None if culled else t1, self.pack)
        self.age += rounds_a + (0 if culled else rounds_b)
        return culled, float(f.d), res.traj_row

    # ------------------------------------------------------------------
    def update_coupled_mega(self, rounds_a: int, rounds_b: int, iters: int = 2):
        """The fused coupled keyframe step (slam/coupled_fused.py): rounds_a
        update+solve rounds, the multi-sensor cull decision (flow distance +
        translation hysteresis), rounds_b more unless culled.  Returns
        (culled, cull_distance), or None to fall back to the two-call flow
        (window exceeds fg_cap / unsupported factors / coupled mode off).
        A ``step`` span."""
        if (self.n == 0 or self.coupled is None or not self.video.imu_enabled
                or not self.cfg.sensors.device_solver or not self.cfg.sensors.coupled_mega):
            return None
        with TRACER("step"):
            self.flush()
            t0 = max(1, int(self.ii.min()) + 1)
            t1 = int(max(self.ii.max(), self.jj.max())) + 1
            s0 = max(0, t1 - self.cfg.ba.window)
            out = self._update_coupled_fused(rounds_a, rounds_b, iters, True, t0, t1, s0)
        if out is None:
            return None
        culled, d = out
        self.mega_count += 1
        self.age += rounds_a + (0 if culled else rounds_b)
        if culled:
            self.set_prox(None)  # the distances predate the shift
        return culled, d

    def _update_coupled_fused(self, rounds_a: int, rounds_b: int, iters: int,
                              use_inactive: bool, t0: int, t1: int, s0: int):
        """All rounds of a coupled keyframe step on the device
        (slam/coupled_fused.py), one host read of the packed results at the
        end.  Returns (culled, cull_distance), or None to fall back to the
        per-round path."""
        from .coupled_fused import pack_fields, run_coupled_rounds

        dev = self.device
        e_mask, i_mask = self._masks()
        ii, jj = padded(self.ii, self.e_cap), padded(self.jj, self.e_cap)
        sets = self.update_step.edge_sets(ii, jj, e_mask, padded(self.ii_inac, self.i_cap),
                                          padded(self.jj_inac, self.i_cap), i_mask, t0,
                                          use_inactive, dev)
        prep = self.coupled.prepare_device(sets.ii_np, sets.jj_np, sets.mask_np, t1, iters)
        if prep is None:
            return None
        out = run_coupled_rounds(
            self.update_step, self.cfg, self.video, self.edges, torch.as_tensor(ii, device=dev),
            torch.as_tensor(jj, device=dev), torch.as_tensor(e_mask, device=dev), self.t_inac,
            self.w_inac, sets, t1, self.aux, prep, rounds_a, rounds_b, use_inactive)
        self.lm_stats = out.lm_stats
        self.pack = StepPack(out.pack, partial(pack_fields, cfg=self.cfg))
        f = self.host_pack  # one read: the cull pack and the window state rows
        self.set_prox(t1, self.pack)
        self.coupled.take_fused(out.cur_target, out.cur_weight, out.fg_flat, f.rows)
        return bool(f.cull > 0.5), float(f.d)

    @property
    def host_pack(self) -> Optional[StepFields]:
        """The last step's packed results by field, read from the device
        once."""
        return None if self.pack is None else self.pack.on_host()

    # ------------------------------------------------------------------
    def run_upsample(self, agg_fn: Callable):
        """GraphAgg damping and convex disparity upsampling for the frames
        with active edges (covisible_graph.py:239-240, 339-340;
        droid_net.py:40-71), in place on ``video.damping`` and
        ``video.disps_up``.  The head runs on the active edges alone, with
        their frames numbered compactly from the host's edge list, so it
        touches only the frames that take its output (the JAX package runs
        it over the whole buffer, padded edges routed to a dump frame, and
        keeps the same frames' rows; each frame's result is the same).

        agg_fn(net_e (E, H, W, 128), ii (E,), num_frames) -> (eta
        (num_frames, H, W), upmask (num_frames, H, W, 576)).
        """
        if self.n == 0:
            return
        self.flush()
        v = self.video
        frames, local = np.unique(self.ii, return_inverse=True)
        eta, upmask = agg_fn(self.edges.net[:self.n], self._dev(local), len(frames))
        rows = self._dev(frames)
        v.damping.index_copy_(0, rows, eta.float())
        if v.disps_up is not None:
            v.disps_up.index_copy_(0, rows, upsample_disp(v.disps.index_select(0, rows), upmask))

    # ------------------------------------------------------------------
    def add_neighborhood_factors(self, t0: int, t1: int, r: int = 3):
        """Dense all-pairs edges within radius r (covisible_graph.py:344-354)."""
        ii, jj = np.meshgrid(np.arange(t0, t1), np.arange(t0, t1), indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        c = 1 if self.cfg.stereo else 0
        keep = (np.abs(ii - jj) > c) & (np.abs(ii - jj) <= r)
        self.add_factors(ii[keep], jj[keep])

    def _candidate_distances(self, t0, t1, t, ii, jj, beta) -> np.ndarray:
        """Proximity distances: the values the last update step computed on
        its end state when they match this query, else fresh ones."""
        p_t1, pack = self.prox
        if (p_t1 is not None and p_t1 + 1 == t and t0 == t - 5
                and t1 == t - self.cfg.graph.frontend_window and len(ii) == n_prox(self.cfg)):
            return pack.on_host().prox.astype(np.float64)
        return self.video.distance(ii, jj, beta=beta).astype(np.float64)

    def add_proximity_factors(self, t0: int = 0, t1: int = 0, rad: int = 2, nms: int = 2,
                              beta: float = 0.25, thresh: float = 16.0, remove: bool = False):
        """Distance-ranked edge selection with NMS, forced radius edges and
        the opportunistic skip edge (covisible_graph.py:357-441), run by the
        native scheduler ``native/graphops.cpp`` (by
        :func:`select_proximity_edges_py` where it cannot be built).  With
        ``cfg.stereo`` each frame in [t0, t) also takes its self-edge."""
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
        # active, quarantined and inactive edges suppress their neighbours
        exist_ii = np.concatenate([self.ii, self.ii_bad, self.ii_inac])
        exist_jj = np.concatenate([self.jj, self.jj_bad, self.jj_inac])
        res = select_proximity_edges(d, ii, jj, cc, exist_ii, exist_jj, t0, t1, t, rad, nms,
                                     thresh, self.cfg.graph.max_factors)
        if res is None:  # no native scheduler: the Python route
            ii_new, jj_new = select_proximity_edges_py(
                d, ii, jj, cc, exist_ii, exist_jj, t0, t1, t, rad, nms, thresh,
                self.cfg.graph.max_factors, self.cfg.stereo)
        else:
            ii_new, jj_new = res
            if self.cfg.stereo:
                # stereo self-edges ahead of the selection, so that they win
                # the edge capacity (covisible_graph.py:397-399)
                selfs = np.arange(t0, t, dtype=np.int64)
                ii_new = np.concatenate([selfs, ii_new])
                jj_new = np.concatenate([selfs, jj_new])
        if len(ii_new):
            self.add_factors(ii_new, jj_new, remove)


def select_proximity_edges_py(d, ii, jj, cc, exist_ii, exist_jj, t0, t1, t, rad, nms, thresh,
                              max_factors, stereo: bool):
    """The selection of ``native/graphops.cpp`` in Python, as the JAX
    package runs it without the library (dbaf_tpu/slam/graph.py:1214-1271):
    with ``stereo`` every frame's self-edge comes first in its row and its
    candidate is masked.  Returns (ii_out, jj_out) in its order."""
    d = np.array(d, dtype=np.float64)
    d[ii - rad < jj] = np.inf
    d[d > 100] = np.inf

    def suppress(i, j):
        r_n = max(min(abs(int(i) - int(j)) - 2, nms), 0)
        for di in range(-nms, nms + 1):
            for dj in range(-nms, nms + 1):
                if abs(di) + abs(dj) <= r_n:
                    i1, j1 = int(i) + di, int(j) + dj
                    if t0 <= i1 < t and t1 <= j1 < t:
                        d[(i1 - t0) * (t - t1) + (j1 - t1)] = np.inf

    for i, j in zip(exist_ii, exist_jj):
        suppress(i, j)
    es = []
    for i in range(t0, t):
        if stereo:
            es.append((i, i))
            k_self = (i - t0) * (t - t1) + (i - t1)
            if 0 <= k_self < cc:
                d[k_self] = np.inf
        for j in range(max(i - rad - 1, 0), i):
            es.append((i, j))
            es.append((j, i))
            if (i - t0) * (t - t1) + (j - t1) >= 0:
                d[(i - t0) * (t - t1) + (j - t1)] = np.inf
    for k in np.argsort(d):
        if k >= cc or d[k] > thresh:
            continue
        if len(es) > max_factors:
            break
        i, j = int(ii[k]), int(jj[k])
        es.append((i, j))
        es.append((j, i))
        suppress(i, j)
    if ii.shape[0] > cc:  # the opportunistic best skip edge (covisible_graph.py:434-438)
        sub = d[cc:ii.shape[0]]
        k = int(np.argmin(sub))
        if thresh > sub[k] > 0:
            es.append((int(ii[cc + k]), int(jj[cc + k])))
            es.append((int(jj[cc + k]), int(ii[cc + k])))
    if not es:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    out = np.asarray(es, dtype=np.int64)
    return out[:, 0], out[:, 1]


def select_proximity_edges(d, ii, jj, cc, exist_ii, exist_jj, t0, t1, t, rad, nms, thresh,
                           max_factors):
    """Run the native edge scheduler; returns (ii_out, jj_out) in its order,
    or None where the library cannot be built (dbaf_tpu/utils/native.py:75-85)."""
    import ctypes

    from ..utils.cuda_build import load_graphops

    try:
        lib = load_graphops()
    except RuntimeError:
        return None
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
