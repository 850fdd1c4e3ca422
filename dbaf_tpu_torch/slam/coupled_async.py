"""The zero-pull asynchronous coupled pipeline (port of
``dbaf_tpu/slam/coupled_async.py``).

The fused coupled step (``slam/coupled_fused.py``) runs a keyframe's rounds,
its factor-graph solve and its cull decision on the device, but then the
host reads the packed result back once per keyframe, because three of its
consumers live on the host: the proximity-edge bookkeeping, the solved
window state that seeds the next keyframe, and the window-advance
marginalization.  This module moves all three onto the device:

* the edge lifecycle through the device scheduler (``slam/edge_select.py``,
  bit-equal to the host one, with the multi-sensor stale rule);
* the state continuation: the factor-graph window state stays on the device
  between keyframes, and the new keyframe's row and the video pose seed are
  predicted from the last state row and the uploaded preintegration
  (dbaf_frontend.py:222-228);
* the window-advance marginalization (``device_graph.marginalize_window_body``),
  with the packed factor graph uploaded afresh per keyframe (host data only:
  the preintegrations never depend on the solve).

Per keyframe the host ingests the sensors, packs the factor graph into one
blob and uploads it through pinned memory, runs :func:`coupled_step`, and
drains the PREVIOUS step's pack: a ``non_blocking`` copy into pinned memory
behind a CUDA event, waited on alone, so the read never waits for the step
just launched.  A culled keyframe is applied at the start of the next step
(video-row shifts, edge re-indexing, the dropped factor-window row, the two
IMU intervals composed into one, the culled frame's GNSS/odometry
measurement re-linked onto its predecessor inside the device marginal); the
host mirrors it after the drain.  A rollup runs inside the step, and the
host replays the same decision after its drain.  Trajectory rows stay on the
device until ``DBAFusion.terminate``.

Where the JAX step branches with ``lax.cond`` on device predicates, this
port selects with ``torch.where`` (small state) or gathers whose index is
the identity when nothing happens (buffer moves): both branches are
computed and the result is exact.  The LM loop and the rounds after the cull
decision poll their flags without waiting
(:class:`~dbaf_tpu_torch.utils.device.FlagPoll`) and run masked iterations
while the answer is not in.  A steady-state :meth:`CoupledAsync.step` makes
no synchronising CUDA call besides two event waits: the drain's, and the LM
loop's on its own flag of one iteration back, which bounds how far its
graph replays run ahead of the card
(:func:`~dbaf_tpu_torch.fusion.device_graph.lm_optimize`).

With ``cfg.save_pkl`` the step also returns the rows a rollup retires,
captured before the roll (``roll_out``: pose and disparity), copied to
pinned memory ahead of the pack; the host replays the roll with their
timestamps and thumbnails and archives them at the next drain, whose wait
on the pack covers the copy, so archival adds no read and no drain.

With the monitor on (and its debug views off) each drained pack feeds it
the keyframe's decision-time pose and gyro bias, one keyframe behind the
solve, at no extra read.

Scope: the post-VI-init steady state; reinitialization drains back to the
synchronous flow.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..fusion import device_graph as dg
from ..fusion import preint_device as pint
from ..ops import lie
from ..ops import projective as pj
from ..utils.config import DBAFusionConfig
from ..utils.device import FlagPoll, PendingRead, device_const, rows_at, set_row, to_host, upload
from ..utils.profiling import TRACER
from .coupled_fused import RoundPolls, pack_fields, run_coupled_rounds
from .edge_select import cull_transition, edge_transition, roll_transition
from .graph import (EDGE_CARRY, EdgeArrays, EdgeSets, StepFields, StepPack, UpdateStep,
                    _rebuild_edges, _rebuild_inactive, prox_fields, read_ints)
from .video import DepthVideo, slot_keyed


def _with_row(arr: torch.Tensor, idx: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """``arr.at[idx].set(row)`` for a 0-d device index (a new tensor)."""
    return arr.index_copy(0, idx.reshape(1), row[None].to(arr.dtype))


def _cull_rows(buf: torch.Tensor, c: int, n: int) -> torch.Tensor:
    """A copy of ``buf`` with its ``n`` rows above slot ``c`` moved down
    one (the host-side video.rm_keyframe of a drain)."""
    out = buf.clone()
    out[c:c + n] = buf[c + 1:c + 1 + n]
    return out


def _inv15(M: torch.Tensor) -> torch.Tensor:
    """Jacobi-scaled f32 inverse of a 15x15 SPD information/covariance
    block (the IMU information spans ~10 decades; a raw f32 inversion loses
    the small pivots).  ``inv_ex`` keeps a singular block on the device
    instead of raising on the host."""
    d = torch.rsqrt(torch.clamp(torch.diagonal(M), min=1e-30))
    S = M * d[:, None] * d[None, :]
    return torch.linalg.inv_ex(S)[0] * d[:, None] * d[None, :]


def _pg_chunk(pg: dg.PackedGraph, s) -> pint.Chunk:
    """IMU factor slot ``s`` of a packed graph as a preintegration Chunk
    (the covariance recovered from the packed information)."""
    at = lambda a: rows_at(a, s)  # noqa: E731
    return pint.Chunk(dR=at(pg.imu_dR), dv=at(pg.imu_dv), dp=at(pg.imu_dp), dt=at(pg.imu_dt),
                      dRg=at(pg.imu_dRg), dvg=at(pg.imu_dvg), dva=at(pg.imu_dva),
                      dpg=at(pg.imu_dpg), dpa=at(pg.imu_dpa), bias0=at(pg.imu_bias0),
                      cov=_inv15(at(pg.imu_info)))


_PG_CHUNK_FIELDS = (
    ("imu_dR", "dR"), ("imu_dv", "dv"), ("imu_dp", "dp"), ("imu_dt", "dt"),
    ("imu_dRg", "dRg"), ("imu_dvg", "dvg"), ("imu_dva", "dva"),
    ("imu_dpg", "dpg"), ("imu_dpa", "dpa"), ("imu_bias0", "bias0"),
)


def _pg_merge_slot(pg: dg.PackedGraph, s: torch.Tensor, NW: int) -> dg.PackedGraph:
    """Merge IMU factor slots ``s`` and ``s+1`` (a keyframe cull joining
    their intervals) into slot ``s`` by exact chunk composition
    (preint_device.compose == the host's sequential re-integration in
    merge_keyframe), shifting the slots above down."""
    NF = NW - 1
    C = pint.compose(_pg_chunk(pg, s), _pg_chunk(pg, s + 1))
    arF = torch.arange(NF, device=pg.imu_dv.device)
    take = torch.clamp(torch.where(arF >= s + 1, arF + 1, arF), 0, NF - 1)
    rep = {name: _with_row(getattr(pg, name), s, getattr(C, c_name))[take]
           for name, c_name in _PG_CHUNK_FIELDS}
    rep["imu_info"] = _with_row(pg.imu_info, s, _inv15(C.cov))[take]
    # slots >= s+1 take their successor's mask (slot NF-1 gathers itself but
    # is forced dead: one interval fewer after a merge)
    rep["imu_mask"] = torch.where(arF >= s + 1, pg.imu_mask[take] & (arF < NF - 1), pg.imu_mask)
    return pg._replace(**rep)


def _pg_cull_frame_rows(pg: dg.PackedGraph, rc: torch.Tensor, NW: int) -> dg.PackedGraph:
    """Drop the per-frame GNSS/odometry rows of culled pack slot ``rc``,
    shifting the slots above down (the host's merge_keyframe list deletion;
    the culled frame's own measurement was re-linked into the marginal
    first, coupled.rm_new_gnss)."""
    arW = torch.arange(NW, device=pg.gnss_pos.device)
    take = torch.clamp(torch.where(arW >= rc, arW + 1, arW), 0, NW - 1)
    above = arW >= rc
    return pg._replace(
        gnss_pos=pg.gnss_pos[take],
        gnss_mask=torch.where(above, pg.gnss_mask[take] & (arW < NW - 1), pg.gnss_mask),
        odo_vel=pg.odo_vel[take],
        odo_mask=torch.where(above, pg.odo_mask[take] & (arW < NW - 1), pg.odo_mask))


def _relink_culled_gnss_odo(pg: dg.PackedGraph, rows, mgd: dg.MargDense, c, o_prev, h0,
                            NW: int) -> dg.MargDense:
    """coupled.rm_new_gnss on the device (reference depth_video.py:272-304):
    when the culled keyframe ``c`` carries a GNSS/odometry measurement, move
    it onto frame c-1 -- offset by the current relative state -- and add the
    LINEARIZED factor to the device marginal, at the marginal's stored lin
    point when frame c-1 is already in it, else at the current state."""
    dev = rows.device
    rc = torch.clamp(c - h0, 0, NW - 1)          # pack slot of the culled frame
    f = torch.clamp(c - 1 - o_prev, 0, NW - 1)   # marginal slot receiving the factors
    row_c = rows_at(rows, torch.clamp(c - o_prev, 0, NW - 1))
    row_p = rows_at(rows, f)
    lin_f = rows_at(mgd.lin, f)
    lin_raw = torch.where(rows_at(mgd.mask, f), lin_f, row_p)
    R_lin, t_lin, v_lin = lin_raw[:9].reshape(3, 3), lin_raw[9:12], lin_raw[12:15]
    H, v = mgd.H, mgd.v
    ar3 = torch.arange(3, device=dev)

    # GNSS (GPSFactor on X(c-1); Cauchy weight at the lin point)
    has_g = rows_at(pg.gnss_mask, rc)
    r_g = t_lin - (rows_at(pg.gnss_pos, rc) - row_c[9:12] + row_p[9:12])
    e2 = r_g @ (pg.gnss_info @ r_g)
    JtL = R_lin.T @ ((pg.gnss_k2 / (pg.gnss_k2 + e2)) * pg.gnss_info)
    mg = has_g.to(H.dtype)
    g_rows = 15 * f + 3 + ar3
    H = H.index_put((g_rows[:, None], g_rows[None, :]), mg * (JtL @ R_lin), accumulate=True)
    v = v.index_put((g_rows,), mg * -(JtL @ r_g), accumulate=True)

    # odometry (VelFactor on X(c-1), V(c-1))
    has_o = rows_at(pg.odo_mask, rc)
    Rc, Rp = row_c[:9].reshape(3, 3), row_p[:9].reshape(3, 3)
    v_new = rows_at(pg.odo_vel, rc) - Rc.T @ row_c[12:15] + Rp.T @ row_p[12:15]
    vb = R_lin.T @ v_lin
    Jo = torch.cat([dg._hat(vb), R_lin.T], dim=1)  # (3, 6) over [w, vel]
    JtLo = Jo.T @ pg.odo_info
    mo = has_o.to(H.dtype)
    o_rows = torch.cat([15 * f + ar3, 15 * f + 6 + ar3])
    H = H.index_put((o_rows[:, None], o_rows[None, :]), mo * (JtLo @ Jo), accumulate=True)
    v = v.index_put((o_rows,), mo * -(JtLo @ (vb - v_new)), accumulate=True)

    any_fct = has_g | has_o
    mask = _with_row(mgd.mask, f, rows_at(mgd.mask, f) | any_fct)
    lin = _with_row(mgd.lin, f, torch.where(any_fct, lin_raw, lin_f))
    return dg.MargDense(mask, lin, H, v)


def _roll_pg(pg: dg.PackedGraph, shift, NW: int) -> dg.PackedGraph:
    """Re-base a packed factor graph by ``shift`` window slots (an int or a
    0-d device tensor, >= 0).  IMU slot k joins frames (origin+k,
    origin+k+1); prior frames are window-relative (pack_graph_np)."""
    NF = NW - 1
    dev = pg.imu_dv.device
    arF = torch.arange(NF, device=dev)
    arW = torch.arange(NW, device=dev)
    tF = (arF + shift) % NF  # torch.roll(x, -shift) as a gather
    tW = (arW + shift) % NW
    rep = {name: getattr(pg, name)[tF] for name in (
        "imu_dR", "imu_dv", "imu_dp", "imu_dt", "imu_dRg", "imu_dvg", "imu_dva", "imu_dpg",
        "imu_dpa", "imu_bias0", "imu_info")}
    rep["imu_mask"] = pg.imu_mask[tF] & (arF < NF - shift)
    rep["pp_frame"] = pg.pp_frame - shift
    rep["pp_mask"] = pg.pp_mask & (pg.pp_frame >= shift)
    rep["pb_frame"] = pg.pb_frame - shift
    rep["pb_mask"] = pg.pb_mask & (pg.pb_frame >= shift)
    rep["gnss_pos"] = pg.gnss_pos[tW]
    rep["odo_vel"] = pg.odo_vel[tW]
    rep["gnss_mask"] = pg.gnss_mask[tW] & (arW < NW - shift)
    rep["odo_mask"] = pg.odo_mask[tW] & (arW < NW - shift)
    return pg._replace(**rep)


def _predict_row(row_prev: torch.Tensor, pg: dg.PackedGraph, k, g_vec) -> torch.Tensor:
    """NavState propagation of one 21-wide state row through IMU factor
    slot ``k`` (an int or a 0-d device tensor) with first-order bias
    correction (fusion/preintegration.py::predict, multi_sensor.py:114-134),
    and the host's long-gap reset (``MultiSensorState.append_img``): over an
    interval of more than 1 s the state is carried, not propagated."""
    R_i, p_i, v_i, b = row_prev[:9].reshape(3, 3), row_prev[9:12], row_prev[12:15], row_prev[15:21]
    at = lambda a: rows_at(a, k)  # noqa: E731
    db = b - at(pg.imu_bias0)
    dR = at(pg.imu_dR) @ dg._so3_exp(at(pg.imu_dRg) @ db[3:])
    dv = at(pg.imu_dv) + at(pg.imu_dva) @ db[:3] + at(pg.imu_dvg) @ db[3:]
    dp = at(pg.imu_dp) + at(pg.imu_dpa) @ db[:3] + at(pg.imu_dpg) @ db[3:]
    dt = at(pg.imu_dt)
    p_j = p_i + v_i * dt + 0.5 * g_vec * dt * dt + R_i @ dp
    v_j = v_i + g_vec * dt + R_i @ dv
    return torch.where(dt > 1.0, row_prev, torch.cat([(R_i @ dR).reshape(9), p_j, v_j, b]))


def _pose7_cw(R_wb: torch.Tensor, t_wb: torch.Tensor, Tbc12: torch.Tensor) -> torch.Tensor:
    """Camera<-world 7-vec from a body pose and the body<-camera extrinsic
    (dbaf_frontend.py:223-228: Twc = wTb * Tbc; the video stores Tcw)."""
    R_wc = R_wb @ Tbc12[:9].reshape(3, 3)
    t_wc = R_wb @ Tbc12[9:12] + t_wb
    R_cw = R_wc.T
    return torch.cat([-(R_cw @ t_wc), lie.matrix_to_quat(R_cw)]).to(torch.float32)


def _select(on: torch.Tensor, new, old):
    """``torch.where(on, new, old)`` over the fields of a NamedTuple."""
    return type(old)(*(torch.where(on, a, b) for a, b in zip(new, old)))


def coupled_step(ustep: UpdateStep, cfg: DBAFusionConfig, NW: int, video: DepthVideo,
                 edges: EdgeArrays, t_inac: torch.Tensor, w_inac: torch.Tensor, st: dict,
                 aux: dict, pgf: torch.Tensor, Tbc12: torch.Tensor, A: torch.Tensor,
                 rounds_a: int, rounds_b: int, polls: RoundPolls):
    """One coupled keyframe step with no host read (coupled_async.py
    ``make_coupled_step``).

    The video rows, edge stores and inactive store are updated in place;
    ``st`` is the carried state (``CovisibleGraph.carry``'s,
    ``MultiSensorBA.carry``'s and ``prev_cull``: device tensors); ``pgf`` the uploaded blob [packed factor graph | h0 | t1].
    Returns (new carried state, pack, trajectory 7-vec, aux, device
    counters, rounds run masked, roll_out), with the pack the fused step's
    (``coupled_fused.build_pack``); ``roll_out`` (with ``cfg.save_pkl``,
    else None) holds rows [0, rollup_shift) as [pose | disparity] before a
    rollup could move them."""
    gc, fc = cfg.graph, cfg.frontend
    P = cfg.ba.window
    wf = gc.frontend_window
    skip = tuple(gc.skip_edge) if wf == 5 else ()
    n_skip = len(skip)
    B = video.poses.shape[0]
    dev = video.poses.device
    E, I = st["ii"].shape[0], st["ii_i"].shape[0]
    ar = lambda n: torch.arange(n, device=dev)  # noqa: E731
    big = 10 ** 6
    mgd = dg.MargDense(st["mgd_mask"], st["mgd_lin"], st["mgd_H"], st["mgd_v"])
    G = dg.graph_flat_size(NW)
    h0 = pgf[G].long()
    t1 = pgf[G + 1].long()
    pg_h0 = dg.unflatten_graph(pgf[:G], NW)
    rows = st["fg_flat"].reshape(NW, 21)
    o_prev = st["o_prev"]
    pc = st["prev_cull"]

    # ---- 0. the cull decided by the LAST step (the host learns it at its
    # lagged drain and has already appended this frame and packed the factor
    # graph from its pre-merge state), applied here: the rm_keyframe +
    # merge_keyframe transition of frontend.py's culled branch
    t1r = t1                    # host keyframe count (pre-cull)
    c = t1r - 3                 # culled keyframe (pre-cull numbering)
    # (a0) re-link the culled frame's GNSS/odometry onto its predecessor
    # inside the marginal, then drop its per-frame pack rows; (a) compose its
    # two IMU intervals (== the host's merge_keyframe re-integration)
    mgd = _select(pc, _relink_culled_gnss_odo(pg_h0, rows, mgd, c, o_prev, h0, NW), mgd)
    pg_h0 = _select(pc, _pg_merge_slot(_pg_cull_frame_rows(pg_h0, c - h0, NW), c - 1 - h0, NW),
                    pg_h0)
    # (b) video-row shifts (video.rm_keyframe): exactly two rows sit above
    # the culled slot, the previous keyframe and the just-appended frame;
    # slot-keyed aux leaves (a test oracle's id_map) were uploaded pre-shift
    aux = video.move_rows_device(torch.clamp(c + ar(2), 0, B - 1),
                                 torch.clamp(c + 1 + ar(2), 0, B - 1), pc, aux)
    # (c) edge re-indexing (graph.rm_keyframe); the edge lifecycle's
    # device selection is four ``select`` spans a step: (c), 2, 2b and 6
    with TRACER("select"):
        ct = cull_transition(st["ii"], st["jj"], st["age"], st["e_valid"], st["ii_i"],
                             st["jj_i"], st["i_valid"], c)
        no_new_e = torch.zeros(E, dtype=torch.bool, device=dev)
        no_act_i = torch.zeros(I, dtype=torch.bool, device=dev)
        zero_i = torch.zeros(I, dtype=torch.int64, device=dev)
        edges.assign(_rebuild_edges(edges, torch.where(pc, ct["perm"], ar(E)), no_new_e,
                                    ct["ii"], ct["jj"], video.poses, video.disps,
                                    video.intrinsics, video.feature_rows("nets", ct["ii"])))
        t_new, w_new = _rebuild_inactive(t_inac, w_inac,
                                         torch.where(pc, ct["inact_perm_old"], ar(I)),
                                         no_act_i, zero_i, edges.target, edges.weight)
        t_inac.copy_(t_new)
        w_inac.copy_(w_new)
        ii, jj, age, e_valid, ii_i, jj_i, i_valid = (
            torch.where(pc, ct[k], st[s]) for k, s in (
                ("ii", "ii"), ("jj", "jj"), ("age", "age"), ("valid", "e_valid"),
                ("ii_i", "ii_i"), ("jj_i", "jj_i"), ("i_valid", "i_valid")))
    # (d) the factor-graph window state drops the culled row
    arW = ar(NW)
    rc = c - o_prev
    rows = torch.where(pc, rows[torch.clamp(torch.where(arW >= rc, arW + 1, arW), 0, NW - 1)], rows)
    # the effective keyframe count; last_t1 and cur_ii/cur_jj keep the raw
    # numbering, as the synchronous host flow does
    t1 = t1r - pc.long()

    # ---- 1. state continuation and IMU pose seed (sync_host -> set_pose;
    # the solved window state never left the device)
    k_seed = torch.clamp(t1 - 2 - h0, 0, NW - 2)
    row_prev = rows_at(rows, torch.clamp(t1 - 2 - o_prev, 0, NW - 1))
    new_row = _predict_row(row_prev, pg_h0, k_seed, pg_h0.g_vec)
    rows = _with_row(rows, torch.clamp(t1 - 1 - o_prev, 0, NW - 1), new_row)
    set_row(video.poses, torch.clamp(t1 - 1, 0, B - 1),
            _pose7_cw(new_row[:9].reshape(3, 3), new_row[9:12], Tbc12))

    # ---- 1b. after a cull the carried proximity distances predate the
    # shift: fresh ones on the post-cull poses, the new frame's IMU seed
    # included (frontend.py:341-371 order), hence after step 1
    pi_ = (t1 - 5 + ar(5))[:, None].expand(5, wf).reshape(-1)
    pj_ = (t1 - wf + ar(wf)).repeat(5)
    if n_skip:
        pi_ = torch.cat([pi_, t1 - 1 + 0 * ar(n_skip)])
        pj_ = torch.cat([pj_, t1 - 5 + device_const(skip, torch.int64, dev)])
    fresh = pj.frame_distance_bidirectional(video.poses, video.disps, video.intrinsics,
                                            torch.clamp(pi_, 0, B - 1),
                                            torch.clamp(pj_, 0, B - 1), beta=gc.beta)
    prox_d = torch.where(pc, fresh, st["prox_d"])

    # ---- 2. edge lifecycle (frontend.py multi-sensor stale rule +
    # proximity selection)
    with TRACER("select"):
        tr = edge_transition(
            ii, jj, age, e_valid, ii_i, jj_i, i_valid, st["bad_ii"], st["bad_jj"],
            st["bad_valid"], prox_d, t1, gc.frontend_thresh, src=5, wf=wf, n_skip=n_skip,
            skip_offsets=skip, rad=gc.frontend_radius, nms=gc.frontend_nms,
            max_factors=gc.max_factors, max_age=gc.max_age, active_window=fc.active_window,
            visual_only=False, max_out=4 * (gc.max_factors + 60))
        t_new, w_new = _rebuild_inactive(t_inac, w_inac, tr["inact_perm_old"],
                                         tr["inact_from_act"], tr["inact_act_idx"],
                                         edges.target, edges.weight)
        t_inac.copy_(t_new)
        w_inac.copy_(w_new)
        edges.assign(_rebuild_edges(edges, tr["perm"], tr["is_new"], tr["ii"], tr["jj"],
                                    video.poses, video.disps, video.intrinsics,
                                    video.feature_rows("nets", tr["ii"])))
    ii2, jj2, age2, e_valid2 = tr["ii"], tr["jj"], tr["age"], tr["valid"]
    ii_i2, jj_i2, i_valid2 = tr["ii_i"], tr["jj_i"], tr["i_valid"]

    # ---- 2b. rollup (dbaf_frontend.py:253-257), in the sync flow's order:
    # after the edge selection, before the window selection.  Index
    # bookkeeping only: the factor pack, window rows, marginal and proximity
    # distances are origin-relative or shift-invariant, so the video rows
    # roll and absolute frame indices re-base.  The host replays the same
    # decision right after its drain.
    do_roll = t1 > fc.rollup_start
    shift = torch.where(do_roll, fc.rollup_shift, 0)
    roll_out = None
    if cfg.save_pkl:  # the rows a roll retires, for the host archive
        r = fc.rollup_shift
        roll_out = torch.cat([video.poses[:r], video.disps[:r].reshape(r, -1)], 1)
    aux = video.rollup_device(shift, aux)
    # inactive and bad stores: drop negatives, compact, re-index; active
    # edges stay nonnegative by rollup_start - rollup_shift >= active_window
    # (checked at activation)
    with TRACER("select"):
        rt = roll_transition(ii_i2, jj_i2, i_valid2, st["bad_ii"], st["bad_jj"],
                             st["bad_valid"], fc.rollup_shift)
        ii_i2, jj_i2, i_valid2, bad_ii, bad_jj, bad_valid = (
            torch.where(do_roll, rt[k], old) for k, old in (
                ("ii_i", ii_i2), ("jj_i", jj_i2), ("i_valid", i_valid2),
                ("bad_ii", st["bad_ii"]), ("bad_jj", st["bad_jj"]),
                ("bad_valid", st["bad_valid"])))
        t_new, w_new = _rebuild_inactive(t_inac, w_inac,
                                         torch.where(do_roll, rt["inact_perm_old"], ar(I)),
                                         no_act_i, zero_i, edges.target, edges.weight)
        t_inac.copy_(t_new)
        w_inac.copy_(w_new)
    ii2, jj2 = ii2 - shift, jj2 - shift
    cur_ii, cur_jj = st["cur_ii"] - shift, st["cur_jj"] - shift
    o_prev, h0, t1, t1r = o_prev - shift, h0 - shift, t1 - shift, t1r - shift

    # ---- 3. coupled window selection (graph.update_coupled_mega +
    # coupled.prepare_device index logic)
    t0_a = torch.clamp(torch.min(torch.where(e_valid2, ii2, big)) + 1, min=1)
    keep_i = i_valid2 & (ii_i2 >= t0_a - gc.inac_range) & (jj_i2 >= t0_a - gc.inac_range)
    ii_full = torch.cat([ii_i2, ii2])
    jj_full = torch.cat([jj_i2, jj2])
    valid_full = torch.cat([keep_i, e_valid2])
    sel_min = torch.minimum(torch.min(torch.where(valid_full, ii_full, big)),
                            torch.min(torch.where(valid_full, jj_full, big)))
    t0_c = torch.maximum(sel_min, o_prev)  # the window never moves back

    # ---- 4. window-advance marginalization (coupled._marginalize_device:
    # the visual information of the previous selection's out-of-window
    # edges, the factors anchored on the eliminated frames, the old marginal)
    m = t0_c - o_prev
    last_t1 = t1r - 1  # the host stores last_t1 at solve time and never re-numbers it
    marg_idx = (st["cur_mask"] & (cur_ii >= o_prev) & (cur_ii < t0_c)
                & (cur_ii < last_t1 - 2) & (cur_jj < last_t1 - 2))
    marg_t1 = torch.maximum(torch.max(torch.where(marg_idx, cur_jj, -1)) + 1, t0_c + 1)
    # the old-window state: the new keyframe's predicted row sits at the
    # first invalid slot, and the marginalization reads only slots < k_end
    mgd_m = dg.marginalize_window_body(
        video.poses, video.disps, video.damping, video.intrinsics, st["cur_target"],
        st["cur_weight"], torch.clamp(cur_ii - o_prev, 0, P - 1),
        torch.clamp(cur_jj - o_prev, 0, P - 1), marg_idx, o_prev,
        dg.unflatten_state(rows.reshape(-1), last_t1 - o_prev, NW),
        _roll_pg(pg_h0, o_prev - h0, NW), mgd, A, m, marg_t1 - o_prev, P=P, NW=NW,
        eps_damping=cfg.ba.eps_damping)
    mgd2 = _select(m > 0, mgd_m, mgd)

    # ---- 5. re-base the state and the graph to the new origin
    n_fg = t1 - t0_c
    fg = dg.unflatten_state(rows[(arW + m) % NW].reshape(-1), n_fg, NW)
    pg_c = _roll_pg(pg_h0, t0_c - h0, NW)

    # ---- 6. compaction of the coupled edge selection
    with TRACER("select"):
        order = torch.argsort((~valid_full).to(torch.int32), stable=True)
        mask_d = ar(I + E) < valid_full.long().sum()
        prep = dict(t0=t0_c, n=n_fg, fg=fg, sel=order,
                    ii=torch.clamp(ii_full[order] - t0_c, 0, P - 1),
                    jj=torch.clamp(jj_full[order] - t0_c, 0, P - 1), mask=mask_d, pg=pg_c,
                    mgd=mgd2, A=A)

    # ---- 7. rounds and the cull decision (the fused step's core)
    res = run_coupled_rounds(ustep, cfg, video, edges, ii2, jj2, e_valid2, t_inac, w_inac,
                             EdgeSets(ii_full, jj_full, valid_full, None, None, None), t1, aux,
                             prep, rounds_a, rounds_b, True, polls)
    cull = res.cull
    age3 = torch.where(e_valid2, age2 + rounds_a + torch.where(cull, 0, rounds_b), age2)

    # ---- 8. tail: seed the next incoming slot (video.seed_next) and the
    # trajectory row from the decision-time body pose
    slot = torch.clamp(t1, 0, B - 1)
    src = torch.clamp(t1 - 1, 0, P - 1)
    set_row(video.poses, slot, rows_at(video.poses, src))
    set_row(video.disps, slot, rows_at(video.disps, src).mean().expand(video.disps.shape[1:]))
    fields = pack_fields(res.pack, cfg)
    wtb = fields.pose
    traj7 = torch.cat([wtb[9:12], lie.matrix_to_quat(wtb[:9].reshape(3, 3))]).to(torch.float32)
    state = dict(
        ii=ii2, jj=jj2, age=age3, e_valid=e_valid2, ii_i=ii_i2, jj_i=jj_i2, i_valid=i_valid2,
        bad_ii=bad_ii, bad_jj=bad_jj, bad_valid=bad_valid,
        prox_d=fields.prox, fg_flat=res.fg_flat, o_prev=t0_c,
        mgd_mask=mgd2.mask, mgd_lin=mgd2.lin, mgd_H=mgd2.H, mgd_v=mgd2.v,
        cur_ii=ii_full[order], cur_jj=jj_full[order], cur_mask=mask_d,
        cur_target=res.cur_target, cur_weight=res.cur_weight,
        # resolved at the start of the NEXT step, and by the host at its drain
        prev_cull=cull)
    # [realized LM iterations, LM passes, rounds undone by this cull]
    stats = torch.stack([res.lm_stats.sum(), torch.count_nonzero(res.lm_stats),
                         cull.long() * res.masked])
    return state, res.pack, traj7, aux, stats, res.masked, roll_out


class CoupledAsync:
    """Streams coupled keyframes through :func:`coupled_step`."""

    def __init__(self, frontend):
        self.fe = frontend
        self.cfg = frontend.cfg
        self.state: Optional[dict] = None
        self.active = False
        self.steps = 0        # steps since the last activation
        self.total_steps = 0  # lifetime async keyframes
        self.culls = 0        # lifetime async culls
        self.rollups = 0      # lifetime rollups inside the pipeline
        # packs awaiting the lagged drain, oldest first
        self.pending = []
        self.polls = RoundPolls(FlagPoll(), FlagPoll())
        self.masked_rounds = 0   # rounds_b run before the cull decision was in
        self._stats = None       # device [realized LM iterations, LM passes, wasted rounds]
        # save_pkl: rows retired by in-step rollups, awaiting the host archive:
        # (tstamps, thumbnails, PendingRead of roll_out, archive_mark at the roll)
        self._pending_archive = []

    # ------------------------------------------------------------------
    def can_activate(self) -> bool:
        fe = self.fe
        cfg = self.cfg
        coupled = fe.coupled
        NW = cfg.sensors.fg_cap
        return (
            cfg.sensors.coupled_async and cfg.sensors.device_solver and cfg.sensors.coupled_mega
            and fe.video.imu_enabled
            # upsample, stereo and RGB-D input stay on the synchronous flow
            and not cfg.upsample and not cfg.stereo and not fe.video.has_depth
            and coupled is not None
            and not coupled.reinit
            and coupled.has_device_window()
            and coupled.cur_target is not None
            # the last synchronous keyframe must NOT have culled: the host
            # then keeps its window state and last_t1 in pre-cull numbering
            # against post-cull video and edge stores
            and fe.t1 == coupled.last_t1
            # GNSS configurations wait for georeferencing (init_gnss
            # rewrites every pose, a host-side event)
            and (len(fe.all_gnss) == 0 or coupled.gnss_init_time > 0.0)
            and len(coupled.prior_factor_map) == 0
            # capacity: the window can never outgrow the state buffer
            and NW >= cfg.frontend.active_window + cfg.graph.inac_range + 4
            and coupled.last_t1 - coupled.last_t0 <= NW - 2
        )

    # ------------------------------------------------------------------
    def activate(self):
        fe = self.fe
        g, v, coupled = fe.graph, fe.video, fe.coupled
        cfg = self.cfg
        fc = cfg.frontend
        if (fc.rollup_start + 2 <= cfg.buffer
                and fc.rollup_start - fc.rollup_shift < fc.active_window):
            # a rollup is reachable and the in-step roll cannot fail loudly:
            # enforce up front what graph.shift_indices checks on the host
            raise ValueError(
                "coupled async rollup needs rollup_start - rollup_shift >= active_window "
                f"({fc.rollup_start} - {fc.rollup_shift} < {fc.active_window})")
        g.flush()
        coupled.sync_host()
        dev = v.device
        self.state = dict(**g.carry(fe.t1), **coupled.carry(g.e_cap + g.i_cap),
                          prev_cull=torch.as_tensor(np.bool_(False), device=dev))
        if self._stats is None:
            self._stats = torch.zeros(3, dtype=torch.int64, device=dev)
        self.active = True
        self.steps = 0
        self.pending.clear()
        self._last_t1 = fe.t1  # == coupled.last_t1 (can_activate)
        self._drained_cull = False  # cull flag of the last drained pack

    # ------------------------------------------------------------------
    def step(self, cur_t: float):
        """One keyframe (the frontend has ingested the sensors and bumped
        t1).  No host read but the previous step's drain; the trajectory
        row stays on the device.  A ``step`` span."""
        with TRACER("step"):
            self._step(cur_t)

    def _step(self, cur_t: float):
        fe = self.fe
        g, v, coupled = fe.graph, fe.video, fe.coupled
        cfg = self.cfg
        NW = cfg.sensors.fg_cap
        t1 = fe.t1
        h0 = max(0, t1 - NW)
        pgf = dg.pack_graph_flat(coupled, h0, t1, NW)
        if pgf is None:
            raise RuntimeError("coupled async: the factor pack exceeds its capacity")
        blob = upload(np.concatenate([pgf, np.asarray([h0, t1], np.float32)]), v.device)
        state, pack, traj7, aux, stats, masked, roll_out = coupled_step(
            g.update_step, cfg, NW, v, g.edges, g.t_inac, g.w_inac, self.state, g.aux, blob,
            coupled.tbc12_device(), coupled.adjoint_block(), fe.iters1, fe.iters2, self.polls)
        # enqueued ahead of the pack's copy, so the drain's wait covers it
        retired = PendingRead(roll_out) if roll_out is not None else None
        self.state = state
        g.aux = aux
        self._stats += stats
        self.masked_rounds += masked
        self.steps += 1
        self.total_steps += 1
        fe.keyframe_steps += 1
        # the drain's span names this frame as its cause
        self.pending.append(PendingRead(pack, t1, cur_t, TRACER.frame))
        if len(self.pending) > 1:
            self._drain_one()
        # replay the step's rollup decision (post-cull count > rollup_start;
        # fe.t1 reflects the drained cull) before the next pack is built
        if fe.t1 > cfg.frontend.rollup_start:
            self._host_roll(cfg.frontend.rollup_shift, retired)
        # the keyframe count the carried state is numbered at
        self._last_t1 = fe.t1
        g.mega_count += 1
        fe.trajectory.append((cur_t, traj7))

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Counters over the pipeline's life (one host read): realized LM
        iterations and passes, LM iterations launched (masked ones
        included), rounds run before their cull decision was in, and those
        of them undone by a cull."""
        lm, passes, wasted = (int(x) for x in to_host(self._stats))
        return dict(lm_iters=lm, lm_passes=passes, lm_launched=self.polls.lm.posted,
                    masked_rounds=self.masked_rounds, wasted_rounds=wasted)

    def _resolve_archives(self, wait: bool):
        """Archive the rows of the replayed rollups (``_host_roll``), each
        past the archive mark it had at its roll.  Their copies landed
        before the pack a drain waited for; ``wait`` (a sync, whose last
        roll's pack is never drained) waits for each."""
        v = self.fe.video
        while self._pending_archive:
            tstamps, images, retired, mark0 = self._pending_archive.pop(0)
            rows = retired.read() if wait else retired.landed()
            v.append_saved(tstamps[mark0:], rows[mark0:], images[mark0:])

    def _drain_one(self):
        p = self.pending.pop(0)
        t1_at, cur_t, frame = p.meta
        with TRACER("drain", cause=frame):
            pack = pack_fields(p.read(), self.cfg)
            self._resolve_archives(wait=False)
            self._refresh_mirrors_from_pack(pack, t1_at)
            self._monitor_from_pack(pack, t1_at, cur_t)
            culled = bool(pack.cull > 0.5)
            fe = self.fe
            fe.update_rounds += fe.iters1 + (0 if culled else fe.iters2)
            if culled:
                # the culled frame is ALWAYS the third-newest at drain time:
                # the cull removed the then-second-newest keyframe, exactly
                # one frame has been appended since (lag 1), and drains are
                # in order
                self._host_apply_cull(fe.t1 - 3)
            self._drained_cull = culled

    def _window_t1(self, t1_at: int) -> int:
        """A drained step's keyframe count: the host's t1 at dispatch, less
        the PREVIOUS pack's cull (applied at the step's start), less the
        step's own rollup; its post-roll numbering is the host's at drain
        time."""
        fc = self.cfg.frontend
        t1_k = t1_at - int(self._drained_cull)
        if t1_k > fc.rollup_start:
            t1_k -= fc.rollup_shift
        return t1_k

    def _monitor_from_pack(self, pack: StepFields, t1_at: int, cur_t: float):
        """Feed the monitor from a drained pack (its fields): the
        decision-time body pose and the keyframe's solved gyro bias ride it,
        so the rows cost no read; they lag the solve by one keyframe.  A
        summary at each rollup."""
        mon = self.fe.monitor
        if mon is None:
            return
        NW = self.cfg.sensors.fg_cap
        t0_c, t1_k = int(pack.t0), self._window_t1(t1_at)
        T = np.eye(4)
        T[:3, :3] = pack.pose[:9].reshape(3, 3)
        T[:3, 3] = pack.pose[9:12]
        mon.record_keyframe(cur_t, T, gyro_bias=pack.rows[int(np.clip(t1_k - 1 - t0_c, 0, NW - 1)),
                                                          18:21])
        if t1_at - int(self._drained_cull) > self.cfg.frontend.rollup_start:
            mon.dump_summary()

    def _refresh_mirrors_from_pack(self, pack: StepFields, t1_at: int):
        """Mirror the drained pack's solved window into the host
        MultiSensorState (wTbs/vs/bs), the asynchronous counterpart of the
        synchronous flow's sync_host at no extra read: it keeps the ZUPT
        gate, the GNSS lever arm and the preintegration biases one keyframe
        behind the solve.  Frames appended after the drained step are
        re-predicted from the refreshed states."""
        from ..fusion.preintegration import NavState
        from ..fusion.se3np import Pose

        ms = self.fe.coupled.state
        t0_c, t1_k = int(pack.t0), self._window_t1(t1_at)
        n = len(ms)
        for i in range(max(t0_c, 0), min(t1_k, n)):
            row = np.asarray(pack.rows[i - t0_c], np.float64)
            ms.wTbs[i] = Pose(row[:9].reshape(3, 3), row[9:12])
            ms.vs[i] = row[12:15]
            ms.bs[i] = row[15:21]
        for i in range(max(min(t1_k, n), 1), n):
            pim = ms.preintegrations[i - 1]
            prev = NavState(ms.wTbs[i - 1], ms.vs[i - 1])
            prop = prev if pim.dt > 1.0 else pim.predict(prev, ms.bs[i - 1])
            ms.wTbs[i] = prop.pose
            ms.vs[i] = prop.vel
            ms.bs[i] = ms.bs[i - 1].copy()

    def _host_roll(self, roll: int, retired: Optional[PendingRead]):
        """Mirror the step's rollup into the host-only state: timestamps,
        thumbnails, the MultiSensorState window and the frontend counters
        (the device rows, stores and aux were rolled by the step).  With
        save_pkl the retired rows' timestamps and thumbnails are kept with
        their device half (``retired``) for the next drain's archive."""
        fe = self.fe
        v = fe.video
        if retired is not None:
            self._pending_archive.append((v.tstamp[:roll].copy(), v.images_small[:roll].copy(),
                                          retired, v.archive_mark))
            v.archive_mark = max(v.archive_mark - roll, 0)
        v.tstamp = np.roll(v.tstamp, -roll)
        v.images_small = np.roll(v.images_small, -roll, axis=0)
        fe.coupled.state.rollup(roll)
        fe.t1 -= roll
        fe.count -= roll
        fe.rollup_count += 1
        self.rollups += 1
        v.counter = fe.t1

    def _host_apply_cull(self, c: int):
        """Mirror a device-decided cull of keyframe ``c`` into the host-only
        state: timestamps, thumbnails and the preintegration merge
        (multi_sensor.merge_keyframe); the step shifted the device rows."""
        fe = self.fe
        v = fe.video
        n = fe.t1
        v.tstamp[c:n - 1] = v.tstamp[c + 1:n]
        v.images_small[c:n - 1] = v.images_small[c + 1:n]
        fe.coupled.state.merge_keyframe(c)
        fe.t1 -= 1
        v.counter = fe.t1
        self.culls += 1
        fe.culls += 1

    # ------------------------------------------------------------------
    def sync(self):
        """Drain back to the synchronous flow: one read of the carried state
        restores every host mirror."""
        if not self.active:
            return
        fe = self.fe
        g, v, coupled = fe.graph, fe.video, fe.coupled
        st = self.state
        # the carried state is numbered at the LAST step's t1; fe.t1 is one
        # higher when the drain fires from inside _update (reinit), where
        # the new frame is already appended and ingested
        t1 = self._last_t1
        in_flight = fe.t1 - t1  # 0 or 1
        # the one pending pack is the last step's: its cull is the carried
        # prev_cull, finished below; its monitor row is recorded here (a
        # read the drain makes only with the monitor on)
        if fe.monitor is not None and self.pending:
            self._monitor_from_pack(pack_fields(self.pending[-1].read(), self.cfg),
                                    *self.pending[-1].meta[:2])
        self.pending.clear()
        self._resolve_archives(wait=True)
        # one read of the carried integers restores the graph and the window
        h = read_ints(st, ("prev_cull", *EDGE_CARRY, *coupled.CARRY_INTS))
        pend_cull = bool(h["prev_cull"][0])
        g.restore(h)
        g.set_prox(t1 if self.steps else None, StepPack(st["prox_d"], prox_fields))
        # pre-cull numbering, as the host flow keeps it; a pending cull's
        # keyframe leaves the window state
        coupled.restore_carry(st, h, t1, culled=t1 - 2 if pend_cull else None)
        if pend_cull:
            # the device never applied its own last cull (the next step
            # would have): finish it on the host, as the synchronous flow's
            # culled branch does, GNSS/odometry re-link included
            c = t1 - 2
            coupled.rm_new_gnss(c)
            g.rm_keyframe(c)  # edges + video-row shifts
            if in_flight:
                # a frame appended after the last step sits one above the
                # culled window top; rm_keyframe shifted only row c+1
                v.copy_row(c + 1, c + 2)
            # slot-keyed aux leaves (a test oracle's id_map) move with the
            # video rows, as the step moves them when it applies a cull; the
            # rounds that follow this drain in the same frame read them
            g.aux = {k: _cull_rows(a, c, 1 + in_flight) if slot_keyed(a, self.cfg.buffer) else a
                     for k, a in g.aux.items()}
            coupled.state.merge_keyframe(c)
            fe.t1 -= 1
            v.counter = fe.t1
            v.seed_next(fe.t1)
            g.set_prox(None)  # the distances predate the shift
            self.culls += 1
            fe.culls += 1
        if self.steps:
            fe.update_rounds += fe.iters1 + (0 if pend_cull else fe.iters2)
        coupled.sync_host()
        if in_flight:
            # the in-flight frame was IMU-propagated from mirrors one
            # keyframe stale: re-predict it from the restored solved state
            from ..fusion.preintegration import NavState

            ms = coupled.state
            pim = ms.preintegrations[-2]
            prev = NavState(ms.wTbs[-2], ms.vs[-2])
            prop = prev if pim.dt > 1.0 else pim.predict(prev, ms.bs[-2])
            ms.wTbs[-1] = prop.pose
            ms.vs[-1] = prop.vel
            ms.bs[-1] = ms.bs[-2].copy()
        self.active = False
        self.state = None
