"""The asynchronous visual pipeline (port of ``dbaf_tpu/slam/async_pipeline.py``).

On the synchronous flow every frame makes one host read: the motion gate's
flow magnitude must reach the host before it can admit the frame, choose
the new edges and run the keyframe step.  Here the whole frame is one
device step with every decision taken on the device -- the deferred cull of
the previous step, the gate (kernel K2), the admission writes, the edge
transition (``slam/edge_select.py``, bit-equal to the host scheduler), the
rollup, and the fused keyframe step's rounds (kernel K1 in each) with its
cull decision -- and the host drains the small per-frame packs ``LAG``
frames late, ``async_drain_batch`` at a time, to mirror timestamps,
thumbnails, the trajectory, culls and rollups.

Where the JAX step branches with ``lax.cond`` on device predicates, this
port selects with ``torch.where`` on small state and moves only the buffer
rows that can be live: the deferred cull moves one row (``ixc + 1 ->
ixc``), the rollup the rows below ``rollup_start + 1`` (the count a rollup
fires at); the admission writes one row at a device index.  Round counts
that depend on the gate go to flag polls (:class:`~dbaf_tpu_torch.slam.
graph.MegaPolls`): rounds whose gate is not known yet run masked, their
writes undone where it is off.  A steady-state :meth:`AsyncPipeline.track`
makes no synchronising CUDA call but the drain's one event wait.

With ``cfg.save_pkl`` the rows a rollup retires must reach the host
archive, so the step never rolls (``host_rollup``): the host watches its
lagged keyframe count and, once it passes ``rollup_start``, drains the
pipeline (:meth:`AsyncPipeline.sync`), runs the synchronous flow's rollup
with its archival and re-enters.  The drain batch is clamped so that the
count the host sees lags the device's by no more than the buffer's
headroom above ``rollup_start``.

Scope: visual-only configurations after initialization (no IMU; stereo
and RGB-D input stay on the synchronous flow, as in the JAX package, and so
does a run with the monitor on: ``DBAFusion`` does not build the pipeline).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..utils.config import DBAFusionConfig
from ..utils.device import FlagPoll, PendingRead, host_wait, rows_at, set_row, to_host, upload
from .edge_select import cull_transition, edge_transition, roll_transition
from .graph import (EDGE_CARRY, MegaPolls, StepPack, UpdateStep, _rebuild_edges,
                    _rebuild_inactive, prox_fields, read_ints)
from .motion_filter import gate
from .video import DepthVideo, move_rows

# packs in flight: the drain waits on the pack of the step LAG steps old
LAG = 2

# pack layout: [admitted, delta, cull, d_cull, roll, trajectory(7), prox...]
_ADM, _CULL, _ROLL, _TRAJ = 0, 2, 4, slice(5, 12)


def visual_step(ustep: UpdateStep, cfg: DBAFusionConfig, video: DepthVideo, edges, t_inac,
                w_inac, st: dict, image: torch.Tensor, feat_fn, ctx_fn, aux: dict,
                polls: MegaPolls, host_rollup: bool = False):
    """One frame with no host read (``make_step_kernel``'s step).

    The video rows, edge stores and inactive store are updated in place;
    ``st`` is the carried state (:meth:`CovisibleGraph.carry`'s, the gate's
    keyframe features, ``t1`` and ``prev_cull``: device tensors), ``image`` the (1, H, W, 3) uint8 frame on the device.  With
    ``host_rollup`` the step never rolls (the host does, between steps).
    Returns (new carried state, pack, aux, rounds run masked as (rounds_a,
    rounds_b), masked rounds whose gate was off, a 0-d device count)."""
    gc, fc = cfg.graph, cfg.frontend
    B = video.poses.shape[0]
    dev = video.poses.device
    E, I = st["ii"].shape[0], st["ii_i"].shape[0]
    ar = lambda n: torch.arange(n, device=dev)  # noqa: E731
    wf = gc.frontend_window
    skip = tuple(gc.skip_edge) if wf == 5 else ()
    no_new_e = torch.zeros(E, dtype=torch.bool, device=dev)
    no_act_i = torch.zeros(I, dtype=torch.bool, device=dev)
    zero_i = torch.zeros(I, dtype=torch.int64, device=dev)

    # ---- 0. the cull decided by the previous step (frontend.resolve_pending:
    # rm_keyframe, seed_next, fresh proximity distances on the shifted state);
    # slot-keyed aux leaves (a test oracle's id_map) move with the row
    pc = st["prev_cull"]
    ixc = torch.clamp(st["t1"] - 2, 0, B - 1)
    aux = video.move_rows_device(ixc, torch.clamp(ixc + 1, 0, B - 1), pc, aux)
    t1 = st["t1"] - pc.long()
    slot = torch.clamp(t1, 0, B - 1)
    prev = torch.clamp(slot - 1, 0, B - 1)
    move_rows(video.poses, slot, prev, pc)
    set_row(video.disps, slot, torch.where(pc, rows_at(video.disps, prev).mean(),
                                           rows_at(video.disps, slot)))
    ct = cull_transition(st["ii"], st["jj"], st["age"], st["e_valid"], st["ii_i"], st["jj_i"],
                         st["i_valid"], ixc)
    edges.assign(_rebuild_edges(edges, torch.where(pc, ct["perm"], ar(E)), no_new_e, ct["ii"],
                                ct["jj"], video.poses, video.disps, video.intrinsics,
                                video.feature_rows("nets", ct["ii"])))
    t_new, w_new = _rebuild_inactive(t_inac, w_inac, torch.where(pc, ct["inact_perm_old"], ar(I)),
                                     no_act_i, zero_i, edges.target, edges.weight)
    t_inac.copy_(t_new)
    w_inac.copy_(w_new)
    ii, jj, age, e_valid, ii_i, jj_i, i_valid = (
        torch.where(pc, ct[k], st[s]) for k, s in (
            ("ii", "ii"), ("jj", "jj"), ("age", "age"), ("valid", "e_valid"), ("ii_i", "ii_i"),
            ("jj_i", "jj_i"), ("i_valid", "i_valid")))
    prox_d = torch.where(pc, ustep.host_metrics(video, t1)[1:], st["prox_d"])

    # ---- 1. the motion gate (K2 on the card); the threshold is read per step
    fmap, delta = gate(feat_fn, ustep.update_fn, image, st["kf_fmap"], st["kf_net"], st["kf_inp"],
                       cfg.corr_whole_blocks)
    thresh = fc.filter_thresh
    adm = delta > thresh if thresh >= 0 else torch.ones((), dtype=torch.bool, device=dev)

    # ---- 2. admission writes: one row each, at the device count
    net0, inp0 = ctx_fn(image)
    for name, row in (("fmaps", fmap), ("nets", net0[0]), ("inps", inp0[0])):
        video.write_feature(name, slot, row, on=adm)
    kf_fmap = torch.where(adm, fmap, st["kf_fmap"])
    kf_net = torch.where(adm, net0[0].to(torch.bfloat16), st["kf_net"])
    kf_inp = torch.where(adm, inp0[0].to(torch.bfloat16), st["kf_inp"])
    t1 = t1 + adm.long()

    # ---- 3. edge transition (visual stale rule + proximity selection),
    # the identity where the frame is rejected
    tr = edge_transition(
        ii, jj, age, e_valid, ii_i, jj_i, i_valid, st["bad_ii"], st["bad_jj"], st["bad_valid"],
        prox_d, t1, gc.frontend_thresh, src=5, wf=wf, n_skip=len(skip), skip_offsets=skip,
        rad=gc.frontend_radius, nms=gc.frontend_nms, max_factors=gc.max_factors,
        max_age=gc.max_age, active_window=fc.active_window, visual_only=True,
        max_out=4 * (gc.max_factors + 60))
    ii2, jj2, age2, e_valid2, ii_i2, jj_i2, i_valid2 = (
        torch.where(adm, tr[k], old) for k, old in (
            ("ii", ii), ("jj", jj), ("age", age), ("valid", e_valid), ("ii_i", ii_i),
            ("jj_i", jj_i), ("i_valid", i_valid)))
    t_new, w_new = _rebuild_inactive(t_inac, w_inac, torch.where(adm, tr["inact_perm_old"], ar(I)),
                                     adm & tr["inact_from_act"], tr["inact_act_idx"], edges.target,
                                     edges.weight)
    t_inac.copy_(t_new)
    w_inac.copy_(w_new)
    edges.assign(_rebuild_edges(edges, torch.where(adm, tr["perm"], ar(E)), adm & tr["is_new"],
                                ii2, jj2, video.poses, video.disps, video.intrinsics,
                                video.feature_rows("nets", ii2)))

    # ---- 4. rollup (dbaf_frontend.py:253-257), in the synchronous flow's
    # place: after the edge selection, before the rounds
    r = fc.rollup_shift
    do_roll = torch.zeros((), dtype=torch.bool, device=dev)
    bad_ii, bad_jj, bad_valid = st["bad_ii"], st["bad_jj"], st["bad_valid"]
    if not host_rollup:
        do_roll = t1 > fc.rollup_start
        shift = torch.where(do_roll, r, 0)
        # slot-keyed aux leaves (a test oracle's id_map) roll with the video,
        # as the synchronous flow's _roll_aux rolls them
        aux = video.rollup_device(shift, aux)
        rt = roll_transition(ii_i2, jj_i2, i_valid2, bad_ii, bad_jj, bad_valid, r)
        ii_i2, jj_i2, i_valid2, bad_ii, bad_jj, bad_valid = (
            torch.where(do_roll, rt[k], old) for k, old in (
                ("ii_i", ii_i2), ("jj_i", jj_i2), ("i_valid", i_valid2), ("bad_ii", bad_ii),
                ("bad_jj", bad_jj), ("bad_valid", bad_valid)))
        t_new, w_new = _rebuild_inactive(t_inac, w_inac,
                                         torch.where(do_roll, rt["inact_perm_old"], ar(I)),
                                         no_act_i, zero_i, edges.target, edges.weight)
        t_inac.copy_(t_new)
        w_inac.copy_(w_new)
        # active edges only re-index: the visual stale rule lets negative
        # indices survive, and the rounds clip them (graph.shift_indices)
        ii2, jj2, t1 = ii2 - shift, jj2 - shift, t1 - shift

    # ---- 5. the fused keyframe step, every round gated on the admission
    big = 10 ** 6
    t0 = torch.clamp(torch.min(torch.where(e_valid2, ii2, big)) + 1, min=1)
    s0 = torch.clamp(t1 - cfg.ba.window, min=0)
    sets = ustep.edge_sets_device(ii2, jj2, e_valid2, ii_i2, jj_i2, i_valid2, t0)
    res, traj, cull, masked = ustep.mega(video, edges, ii2, jj2, e_valid2, t_inac, w_inac, sets,
                                         t0, t1, s0, fc.iters1, fc.iters2, cfg.ba.iters, aux,
                                         run=adm, polls=polls)
    run_b = adm & ~cull
    age3 = torch.where(e_valid2, age2 + adm.long() * fc.iters1 + run_b.long() * fc.iters2, age2)
    wasted = (~adm).long() * masked[0] + (~run_b).long() * masked[1]

    f32 = lambda x: x.to(torch.float32).reshape(-1)  # noqa: E731
    pack = torch.cat([f32(adm), f32(delta), res[:2], f32(do_roll), f32(traj), res[2:]])
    state = dict(ii=ii2, jj=jj2, age=age3, e_valid=e_valid2, ii_i=ii_i2, jj_i=jj_i2,
                 i_valid=i_valid2, bad_ii=bad_ii, bad_jj=bad_jj, bad_valid=bad_valid,
                 kf_fmap=kf_fmap, kf_net=kf_net, kf_inp=kf_inp, t1=t1, prox_d=res[2:],
                 # resolved at the start of the NEXT step, and by sync()
                 prev_cull=cull)
    return state, pack, aux, masked, wasted


class AsyncPipeline:
    """Streams frames through :func:`visual_step` with a lagged drain."""

    def __init__(self, system):
        self.sys = system
        self.cfg = system.cfg
        fc = self.cfg.frontend
        # save_pkl: the host rolls (and archives) between steps, watching its
        # lagged count, which trails the device's by up to LAG + drain_batch
        # frames: keep that inside the buffer's headroom above rollup_start
        self.host_rollup = self.cfg.save_pkl
        batch = int(fc.async_drain_batch)
        if self.host_rollup:
            batch = min(batch, self.cfg.buffer - fc.rollup_start - LAG - 3)
        self.drain_batch = max(1, batch)
        self.state = None
        self.pending: deque = deque()  # PendingRead(pack, tstamp, thumbnail), oldest first
        self.t1_mirror = 0
        self.active = False
        self.polls = MegaPolls(FlagPoll(), FlagPoll())
        self.steps = 0          # lifetime frames through the pipeline
        self.rollups = 0        # lifetime rollups inside the pipeline
        self.host_rollups = 0   # lifetime rollups on the host (save_pkl): drain, roll, re-enter
        self.culls = 0          # lifetime culls inside the pipeline
        self.drains = 0         # lifetime drains (one blocking wait each)
        self.masked_rounds = 0  # rounds run before their gate was known
        self._wasted = None     # device count: masked rounds whose gate was off

    # ------------------------------------------------------------------
    def can_activate(self) -> bool:
        fe = self.sys.frontend
        # upsample stays on the synchronous flow, which runs the GraphAgg
        # head after every keyframe step (the JAX pipeline enters with the
        # flag set and then stops updating damping and disps_up); so do
        # stereo and RGB-D input, as in the JAX package
        return (self.cfg.frontend.async_pipeline and fe.is_initialized
                and fe.all_imu is None and self.sys.graph.coupled is None
                and not self.cfg.upsample and not self.cfg.stereo
                and not self.sys.video.has_depth
                and fe.t1 >= max(self.cfg.graph.frontend_window, 5))

    def activate(self):
        """Enter the pipeline from the synchronized host state."""
        sysm = self.sys
        g, v, fe, flt = sysm.graph, sysm.video, sysm.frontend, sysm.filter
        dev = v.device
        self.state = dict(
            **g.carry(fe.t1), kf_fmap=flt.kf_fmap, kf_net=flt.kf_net, kf_inp=flt.kf_inp,
            t1=upload(np.asarray(fe.t1, np.int64), dev), prev_cull=upload(np.asarray(False), dev))
        if self._wasted is None:
            self._wasted = torch.zeros((), dtype=torch.int64, device=dev)
        self.t1_mirror = fe.t1
        self.pending.clear()
        self.active = True

    # ------------------------------------------------------------------
    def track(self, tstamp: float, image: np.ndarray):
        """One frame: the device step, then the drain of the packs ``LAG``
        steps old once ``drain_batch`` of them are queued."""
        sysm = self.sys
        g, v, flt = sysm.graph, sysm.video, sysm.filter
        image = np.asarray(image, dtype=np.uint8)
        img = upload(image, v.device)[None]
        state, pack, aux, masked, wasted = visual_step(
            g.update_step, self.cfg, v, g.edges, g.t_inac, g.w_inac, self.state, img, flt.feat,
            flt.ctx, g.aux, self.polls, self.host_rollup)
        self.state = state
        g.aux = aux
        self._wasted += wasted
        self.masked_rounds += sum(masked)
        self.steps += 1
        self.pending.append(PendingRead(pack, tstamp, image[::8, ::8].copy()))
        if len(self.pending) >= LAG + self.drain_batch:
            self._drain(self.drain_batch)
        if self.host_rollup and self.t1_mirror > self.cfg.frontend.rollup_start:
            # the synchronous flow's rollup with its archival, between steps:
            # a deliberate drain, so its reads are waits that belong here
            with host_wait():
                self.sync()
                sysm.frontend.rollup()
                self.host_rollups += 1
                self.activate()

    def _drain(self, k: int):
        """Apply the ``k`` oldest packs, waiting once: on the newest of
        them, which is ``LAG`` steps old."""
        batch = [self.pending.popleft() for _ in range(min(k, len(self.pending)))]
        if not batch:
            return
        self.drains += 1
        batch[-1].read()
        for p in batch:
            self._apply_pack(*p.meta, p.landed())

    def _apply_pack(self, tstamp: float, small: np.ndarray, pack: np.ndarray):
        """Mirror one step on the host: timestamps, thumbnails, the
        trajectory row and the frontend's counters (the device rows moved
        in the step)."""
        v, fe = self.sys.video, self.sys.frontend
        fc = self.cfg.frontend
        culled = pack[_CULL] > 0.5
        if pack[_ADM] > 0.5:
            idx = self.t1_mirror
            if idx < len(v.tstamp):
                v.tstamp[idx] = tstamp
                v.images_small[idx] = small
            self.t1_mirror += 1
            fe.trajectory.append((tstamp, pack[_TRAJ].copy()))
            fe.keyframe_steps += 1
            fe.update_rounds += fc.iters1 + (0 if culled else fc.iters2)
        if pack[_ROLL] > 0.5:
            r = fc.rollup_shift
            v.tstamp = np.roll(v.tstamp, -r)
            v.images_small = np.roll(v.images_small, -r, axis=0)
            self.t1_mirror -= r
            fe.rollup_count += 1
            self.rollups += 1
        if culled:
            # the step culled keyframe t1-2; the device moves its rows at
            # the start of the next step
            ix = self.t1_mirror - 2
            v.tstamp[ix] = v.tstamp[ix + 1]
            v.images_small[ix] = v.images_small[ix + 1]
            self.t1_mirror -= 1
            fe.culls += 1
            self.culls += 1
        v.counter = self.t1_mirror

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Counters over the pipeline's life (one host read for the wasted
        rounds)."""
        return dict(steps=self.steps, culls=self.culls, rollups=self.rollups,
                    host_rollups=self.host_rollups,
                    masked_rounds=self.masked_rounds,
                    wasted_rounds=0 if self._wasted is None else int(to_host(self._wasted)))

    def sync(self):
        """Drain every pack and write the device edge state back into the
        host mirrors (one read), so the synchronous flow can resume."""
        while self.pending:
            self._drain(len(self.pending))
        sysm = self.sys
        g, v, fe, flt = sysm.graph, sysm.video, sysm.frontend, sysm.filter
        st = self.state
        h = read_ints(st, ("prev_cull", "t1", *EDGE_CARRY))  # one read
        t1 = int(h["t1"][0])
        g.restore(h)
        g.set_prox(t1, StepPack(st["prox_d"], prox_fields))
        v.counter = fe.t1 = t1
        flt.kf_fmap, flt.kf_net, flt.kf_inp = st["kf_fmap"], st["kf_net"], st["kf_inp"]
        if h["prev_cull"][0]:
            # the last step's cull never reached the device (the next step
            # would have applied it): finish it here, as resolve_pending
            # does, slot-keyed aux leaves moving with the row as the step
            # moves them.  The drain already shifted the timestamps;
            # rm_keyframe's copy of the same host row changes nothing.
            g.rm_keyframe(fe.t1 - 2)
            g.aux = v.rm_keyframe_aux(g.aux, fe.t1 - 2)
            fe.t1 -= 1
            v.seed_next(fe.t1)
            g.set_prox(None)  # the proximity distances predate the shift
        self.t1_mirror = fe.t1
        self.active = False
        self.state = None
