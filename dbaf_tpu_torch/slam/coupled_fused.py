"""The fused coupled keyframe step.

Port of ``dbaf_tpu/slam/coupled_fused.py``.  One coupled keyframe step runs
``rounds_a`` rounds of update (reprojection, correlation -- kernel K1 on the
card -- update operator) and multi-sensor solve (reduced camera system,
factor-graph LM, retraction), then the multi-sensor cull decision (flow
distance + translation hysteresis, dbaf_frontend.py:317-336), then
``rounds_b`` more rounds unless the keyframe is culled.  The JAX package
gates the rounds with ``lax.cond`` inside one ``fori_loop``; here they are
a Python loop; the decision goes to a flag poll, made only when rounds
follow it.  Everything else the host needs -- the cull pack, the
hysteresis norms, the window state rows, the post-``rounds_a`` body pose of
the new keyframe and the window origin -- comes back in one packed read at
the end, laid out by :func:`build_pack` and cut apart by :func:`pack_fields`
(the asynchronous step, ``slam/coupled_async.py``, writes the same pack).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..fusion import device_graph as dg
from ..ops import lie
from ..utils.config import DBAFusionConfig
from ..utils.device import FlagPoll, clip, rows_at
from ..utils.profiling import TRACER
from .graph import EdgeSets, StepFields, UpdateStep, corr_operands, metrics_fields, n_prox
from .video import DepthVideo


def build_pack(cull, d, prox, hyst, fg_flat, pose, t0) -> torch.Tensor:
    """The coupled step's pack on the device: [cull, d, prox..., hyst(7),
    window state(NW*21), pose(12), t0].  ``cull`` is a 0-d bool, ``d`` a
    0-d distance, ``t0`` the window origin (an int or a 0-d tensor)."""
    f32 = torch.float32
    t0 = (t0.to(f32).reshape(1) if isinstance(t0, torch.Tensor)
          else torch.full((1,), float(t0), dtype=f32, device=d.device))
    return torch.cat([cull.to(f32).reshape(1), d.reshape(1), prox, hyst, fg_flat, pose, t0])


def pack_fields(x, cfg: DBAFusionConfig) -> StepFields:
    """The fields of a :func:`build_pack` pack, on the device tensor (as
    views) or on its host copy alike."""
    NW = cfg.sensors.fg_cap
    h = 2 + n_prox(cfg)       # the hysteresis norms' start
    r = h + 7                 # the window state's
    p = r + NW * 21           # the pose's
    return StepFields(cull=x[0], d=x[1], prox=x[2:h], hyst=x[h:r],
                      rows=x[r:p].reshape(NW, 21), pose=x[p:p + 12], t0=x[p + 12])


class CoupledStepResult(NamedTuple):
    pack: torch.Tensor       # build_pack's layout
    cur_target: torch.Tensor
    cur_weight: torch.Tensor
    fg_flat: torch.Tensor    # (NW*21,) window state
    lm_stats: torch.Tensor   # (rounds, lm_iters) realized LM iterations, on the device
    cull: torch.Tensor       # 0-d bool, the keyframe's cull decision
    masked: int              # rounds run before the decision was known (undone on a cull)


class RoundPolls(NamedTuple):
    """The reads of a step's flags: one poll for the LM ``done`` flags, one
    for the cull decision that gates rounds_b."""
    lm: FlagPoll
    cull: FlagPoll


def blocking_polls() -> RoundPolls:
    """The synchronous flow's polls: each post is one host read."""
    return RoundPolls(FlagPoll(blocking=True), FlagPoll(blocking=True))


def hyst_norms(poses: torch.Tensor, t1, P: int) -> torch.Tensor:
    """Translation-hysteresis norms (dbaf_frontend.py:319-325): |rel t|
    between candidates t1-10+k (k < 7) and the reference t1-2.  ``t1`` is
    an int or a 0-d device tensor."""
    cand = torch.clamp(t1 - 10 + torch.arange(7, device=poses.device), 0, P - 1)
    ref = rows_at(poses, clip(t1 - 2, 0, P - 1))
    rel = lie.se3_mul(poses[cand], lie.se3_inv(ref)[None])
    return torch.linalg.norm(rel[:, :3], dim=1)


def run_coupled_rounds(step: UpdateStep, cfg: DBAFusionConfig, video: DepthVideo, edges,
                       ii, jj, e_mask, t_inac, w_inac, sets: EdgeSets, t1, aux: dict,
                       prep: dict, rounds_a: int, rounds_b: int, use_inactive: bool,
                       polls: Optional[RoundPolls] = None) -> CoupledStepResult:
    """Runs in place on ``video`` (poses, disps) and ``edges``.  ``prep`` is
    :meth:`MultiSensorBA.prepare_device`'s output (window origin, packed
    graph and state, edge selection, marginal, adjoint).  ``t1``,
    ``prep["t0"]`` and ``prep["n"]`` are ints or 0-d device tensors.

    The LM ``done`` flags and the cull decision (posted only when rounds
    follow it) go to ``polls``; by default :func:`blocking_polls`, one host
    read each.  With non-blocking polls (the asynchronous step) nothing
    waits for the card: while the cull decision's answer is not in,
    rounds_b run masked -- their writes are undone where the keyframe
    culled, as the JAX ``cond`` skips them."""
    polls = polls or blocking_polls()
    P = cfg.ba.window
    NW = cfg.sensors.fg_cap
    dev = video.poses.device
    fg_t0, n_fg = prep["t0"], prep["n"]
    fg = prep["fg"]
    # round-invariant correlation operands and context features
    corr_prep = corr_operands(cfg, video, ii, jj)
    inp_e = video.feature_rows("inps", ii)
    lm_stats = []
    pack = cur_target = cur_weight = None

    def one(r: int):
        nonlocal fg, pack, cur_target, cur_weight
        with TRACER("round"):
            t_all, w_ba = step.update_round(video, edges, ii, jj, e_mask, t_inac, w_inac, sets,
                                            corr_prep, inp_e, aux, use_inactive)
        if r in (rounds_a - 1, rounds_a + rounds_b - 1):
            # the cull distance and the next keyframe's proximity
            # distances, on the pre-solve state of the deciding/last round
            pack = step.host_metrics(video, t1)
        cur_target = t_all[prep["sel"]]
        cur_weight = w_ba[prep["sel"]]
        with TRACER("lm"):
            _, _, fg, its = dg.coupled_rounds_body(
                video.poses, video.disps, video.damping, video.intrinsics, cur_target,
                cur_weight, prep["ii"], prep["jj"], prep["mask"], fg_t0, n_fg, fg, prep["pg"],
                prep["mgd"], prep["A"], P=P, NW=NW, n_iters=cfg.ba.lm_iters,
                eps_damping=cfg.ba.eps_damping, poll=polls.lm)
        lm_stats.append(torch.stack(its))

    for r in range(rounds_a):
        one(r)
    # the multi-sensor cull decision on the post-rounds_a state: d from the
    # last round's pre-solve pack, hysteresis on the post-solve poses, the
    # out-of-range candidate slots masked like the host's k0 slice
    # (lo = t1 - 10 past ten keyframes, else t1 - 6)
    d = metrics_fields(pack).d
    lo = t1 - 10 + 4 * (t1 <= 10)
    k0 = clip(lo, 0, 1 << 30) - (t1 - 10)
    valid = torch.arange(7, device=dev) >= k0
    hyst = hyst_norms(video.poses, t1, P)
    cull = (d < cfg.frontend.keyframe_thresh) | torch.any(
        (hyst < cfg.frontend.translation_threshold) & valid)
    # the reference writes the trajectory row from the post-iters1 state
    # (dbaf_frontend.py:261-274): snapshot the new keyframe's body pose
    slot = clip(t1 - 1 - fg_t0, 0, NW - 1)
    wtb = torch.cat([rows_at(fg.R, slot).reshape(9), rows_at(fg.t, slot)])
    masked = 0
    if rounds_b > 0:
        polls.cull.reset()
        polls.cull.post(cull)
        known = polls.cull.value()
        if known is None:
            # the decision is still on its way: run rounds_b and undo their
            # writes where the keyframe culled
            bufs = (video.poses, video.disps, edges.net, edges.target, edges.weight)
            saved = [b.clone() for b in bufs]
            keep = (fg, pack, cur_target, cur_weight, len(lm_stats))
            for r in range(rounds_a, rounds_a + rounds_b):
                one(r)
            for buf, old in zip(bufs, saved):
                buf.copy_(torch.where(cull, old, buf))
            fg = dg.FgState(*(torch.where(cull, a, b) for a, b in zip(keep[0][:4], fg[:4])),
                            fg.valid)
            pack, cur_target, cur_weight = (torch.where(cull, a, b) for a, b in
                                            zip(keep[1:4], (pack, cur_target, cur_weight)))
            lm_stats[keep[4]:] = [torch.where(cull, 0, its) for its in lm_stats[keep[4]:]]
            masked = rounds_b
        elif not known:
            for r in range(rounds_a, rounds_a + rounds_b):
                one(r)
    fg_flat = dg.flatten_state(fg)
    out = build_pack(cull, d, metrics_fields(pack).prox, hyst_norms(video.poses, t1, P), fg_flat,
                     wtb, fg_t0)
    return CoupledStepResult(out, cur_target, cur_weight, fg_flat, torch.stack(lm_stats),
                             cull, masked)
