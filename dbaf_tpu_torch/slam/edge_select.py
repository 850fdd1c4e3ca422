"""Device-side proximity/NMS edge selection and edge-store transitions.

Port of ``dbaf_tpu/slam/edge_select.py``: a replica of the host edge
scheduler (``native/graphops.cpp::select_proximity_edges``) -- forced radius
edges, distance-ranked greedy selection with Manhattan-gated NMS
suppression, and the opportunistic best skip edge -- with fixed shapes, so
the asynchronous coupled step (``slam/coupled_async.py``) computes the next
keyframe's edge set on the device, with no host read.

The selection must stay bit-identical to the host scheduler (order
included: the dedup and budget truncation downstream are order-sensitive).
``tests/test_torch_edge_select.py`` fuzzes it against the native scheduler
and the JAX replica.

Of the reference's three ``fori_loop``s, the NMS seeding over the existing
edges and the forced radius edges are order-free (a suppression is a max of
hits, a radius emit has a fixed output position), so each is one vectorised
scatter here.  The greedy pass is sequential: a fixed-trip Python loop of
``src * win + n_skip`` small device steps (28 at the TUM-VI preset), with
no host read.

Indices are int64 tensors; scalars (``t0``, ``t1``, ``t``) are 0-d tensors.
"""

from __future__ import annotations

import torch

from ..utils.device import device_const

INF = float("inf")


def _scatter_into(base: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].set(vals, mode="drop")``: out-of-range positions land
    in a spare slot that is cut off."""
    size = base.shape[0]
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    out = torch.cat([base, base[:1]])
    out.index_put_((idx,), vals.to(base.dtype))
    return out[:size]


def _scatter(size: int, idx: torch.Tensor, vals: torch.Tensor, fill=0) -> torch.Tensor:
    """``full(size, fill).at[idx].set(vals, mode="drop")``."""
    return _scatter_into(torch.full((size,), fill, dtype=vals.dtype, device=vals.device), idx, vals)


def _nms_offsets(nms: int, device):
    """Flattened (2nms+1)^2 offset ball: (DI, DJ, |DI|+|DJ|)."""
    d = torch.arange(-nms, nms + 1, device=device)
    DI, DJ = torch.meshgrid(d, d, indexing="ij")
    DI, DJ = DI.reshape(-1), DJ.reshape(-1)
    return DI, DJ, DI.abs() + DJ.abs()


def _suppress_slots(i, j, on, t0, t1, t, nms_ball, src: int, win: int, nms: int):
    """Grid slots (flat, into a (src*win + 1)-long distance row whose last
    slot is a sink) that a seed (i, j) suppresses (graphops.cpp:30-44): the
    Manhattan ball of radius clamp(|i-j|-2, 0, nms).  ``i, j, on`` broadcast
    against the ball (shape (..., 1))."""
    DI, DJ, manh = nms_ball
    r = torch.clamp((i - j).abs() - 2, 0, nms)
    gi = (i - t0) + DI
    gj = (j - t1) + DJ
    hit = (on & (manh <= r) & (gi >= 0) & (gi < src) & (t0 + gi < t)
           & (gj >= 0) & (gj < win) & (t1 + gj < t))
    return torch.where(hit, gi * win + gj, src * win)


def select_proximity_edges(d, ii_cand, jj_cand, exist_ii, exist_jj, exist_mask, t0, t1, t,
                           thresh: float, *, src: int, win: int, n_skip: int, rad: int, nms: int,
                           max_factors: int, max_out: int):
    """Returns (out_ii, out_jj, out_mask), each (max_out,).

    d, ii_cand, jj_cand: (src*win + n_skip,) candidate distances (f32) and
    endpoints; exist_*: (NE,) existing edges (active + bad + inactive) with
    their validity; t0/t1: candidate source/target range starts; t: the
    frame count.  Mirrors native/graphops.cpp::select_proximity_edges,
    emission order included (forced radius edges first, then ranked pairs
    both ways, then the best skip edge)."""
    dev = d.device
    cc = src * win
    ball = _nms_offsets(nms, dev)

    # candidate validity (graphops.cpp:63-66)
    d = torch.where(ii_cand - rad < jj_cand, INF, d)
    d = torch.where(d > 100.0, INF, d)
    # the grid's distances plus a sink slot; skip candidates are never
    # suppressed (indices >= cc)
    dg = torch.cat([d[:cc], torch.full((1,), INF, dtype=d.dtype, device=dev)])

    # NMS seeds from every valid existing edge at once (graphops.cpp:69)
    slots = _suppress_slots(exist_ii[:, None], exist_jj[:, None], exist_mask[:, None],
                            t0, t1, t, ball, src, win, nms)
    dg = dg.index_fill(0, slots.reshape(-1), INF)

    out_ii = torch.zeros(max_out + 1, dtype=torch.int64, device=dev)
    out_jj = torch.zeros(max_out + 1, dtype=torch.int64, device=dev)

    # forced radius edges (graphops.cpp:77-86): i in [t0, t), j in
    # [max(i-rad-1, 0), i), emitted (i,j) then (j,i) at fixed positions
    k = torch.arange(src * (rad + 1), device=dev)
    i = t0 + k // (rad + 1)
    j = torch.clamp(i - rad - 1, min=0) + k % (rad + 1)
    on = (i < t) & (j < i)
    pos = 2 * (torch.cumsum(on.long(), 0) - on.long())
    for p, a, b in ((pos, i, j), (pos + 1, j, i)):
        dst = torch.where(on & (p < max_out), p, max_out)
        out_ii.index_put_((dst,), a)
        out_jj.index_put_((dst,), b)
    n = torch.clamp(2 * on.long().sum(), max=max_out)
    gi, gj = i - t0, j - t1
    ok = on & (gi >= 0) & (gi < src) & (gj >= 0) & (gj < win)
    dg = dg.index_fill(0, torch.where(ok, gi * win + gj, cc), INF)

    # distance-ranked greedy pass (graphops.cpp:89-103): order by the
    # post-invalidation d, re-check the current (suppressed) d per step
    order = torch.argsort(torch.where(torch.isinf(d), 1e30, d), stable=True)
    cand = torch.stack([ii_cand, jj_cand])
    ar2 = torch.arange(2, device=dev)
    for kk in range(cc + n_skip):
        kq = order[kk:kk + 1]
        dcur = dg.index_select(0, torch.clamp(kq, max=cc))
        on = (kq < cc) & (dcur <= thresh) & (n <= max_factors)
        ij = cand.index_select(1, kq)[:, 0]  # (i, j)
        p = n + ar2
        dst = torch.where(on & (p < max_out), p, max_out)
        out_ii.index_put_((dst,), ij)
        out_jj.index_put_((dst,), ij.flip(0))
        n = n + (dst < max_out).long().sum()
        dg = dg.index_fill(0, _suppress_slots(ij[0], ij[1], on, t0, t1, t, ball, src, win, nms),
                           INF)

    # opportunistic best skip edge (graphops.cpp:106-119)
    if n_skip > 0:
        dskip = torch.where(ii_cand[cc:] - rad < jj_cand[cc:], INF, d[cc:])
        dskip = torch.where(dskip > 100.0, INF, dskip)
        best = torch.argmin(dskip).reshape(1)
        bd = dskip.index_select(0, best)
        on = (bd < thresh) & (bd > 0)
        ij = cand[:, cc:].index_select(1, best)[:, 0]
        p = n + ar2
        dst = torch.where(on & (p < max_out), p, max_out)
        out_ii.index_put_((dst,), ij)
        out_jj.index_put_((dst,), ij.flip(0))
        n = n + (dst < max_out).long().sum()

    mask = torch.arange(max_out, device=dev) < n
    return out_ii[:max_out], out_jj[:max_out], mask


# ---------------------------------------------------------------------------
# Per-keyframe edge-state transitions (device side).
#
# edge_transition replays the host sequence for a new keyframe exactly
# (slam/frontend.py stale retirement + graph.add_proximity_factors /
# add_factors):
#   1. stale retirement (age/window) into the inactive store
#   2. proximity selection from the carried distance pack
#   3. dedup against active+inactive edges and within the new list
#   4. age-ranked budget eviction (also retired to inactive)
#   5. append, producing the (perm, is_new) pair _rebuild_edges consumes.
# Inactive-store appends drop the OLDEST entries on overflow, which composes
# to "concat everything, keep the last i_cap rows".


def _stable_compact(valid: torch.Tensor):
    """positions[k] = output slot of input k (order-preserving), -1 where
    invalid; and the count."""
    pos = torch.cumsum(valid.long(), 0) - 1
    return torch.where(valid, pos, -1), valid.long().sum()


def roll_transition(ii_i, jj_i, i_valid, bad_ii, bad_jj, bad_valid, r):
    """Rollup re-indexing of the inactive and bad-edge stores, the device
    twin of ``graph.shift_indices``: entries whose indices go negative drop,
    survivors compact stably and shift down by ``r``.

    Returns a dict with the new ``ii_i/jj_i/i_valid``, ``inact_perm_old``
    (for ``graph._rebuild_inactive`` with an all-False from_active) and the
    compacted ``bad_ii/bad_jj/bad_valid``."""
    I = ii_i.shape[0]
    dev = ii_i.device
    keep = i_valid & (ii_i >= r) & (jj_i >= r)
    pos, n_k = _stable_compact(keep)
    tgt = torch.where(keep, pos, I)
    ar_i = torch.arange(I, device=dev)
    bcn = bad_ii.shape[0]
    keep_b = bad_valid & (bad_ii >= r) & (bad_jj >= r)
    pos_b, n_b = _stable_compact(keep_b)
    tgt_b = torch.where(keep_b, pos_b, bcn)
    ar_b = torch.arange(bcn, device=dev)
    return dict(
        ii_i=_scatter(I, tgt, ii_i - r), jj_i=_scatter(I, tgt, jj_i - r),
        i_valid=ar_i < n_k, inact_perm_old=_scatter(I, tgt, ar_i),
        bad_ii=_scatter(bcn, tgt_b, bad_ii - r), bad_jj=_scatter(bcn, tgt_b, bad_jj - r),
        bad_valid=ar_b < n_b,
    )


def edge_transition(ii, jj, age, e_valid, ii_i, jj_i, i_valid, bad_ii, bad_jj, bad_valid,
                    prox_d, t1, thresh: float, *, src: int, wf: int, n_skip: int,
                    skip_offsets: tuple, rad: int, nms: int, max_factors: int, max_age: int,
                    active_window: int, visual_only: bool, max_out: int):
    """The new active/inactive index state plus the gather plans (perm /
    is_new for ``_rebuild_edges``; perm_old / from_active / act_idx for
    ``_rebuild_inactive``).  ``prox_d``: (src*wf + n_skip,) distances for
    the new frame; ``t1``: 0-d keyframe count including it."""
    E = ii.shape[0]
    I = ii_i.shape[0]
    dev = ii.device

    # ---- 1. stale retirement (frontend.py:257-266)
    out_win = (ii < t1 - active_window) | (jj < t1 - active_window)
    stale = ((age > max_age) & out_win) if visual_only else ((age > max_age) | out_win)
    stale = stale & e_valid
    keep1 = e_valid & ~stale

    # ---- 2. selection candidates (graph.add_proximity_factors)
    t0 = t1 - src
    t1p = t1 - wf
    cand_i = (t0 + torch.arange(src, device=dev))[:, None].expand(src, wf).reshape(-1)
    cand_j = (t1p + torch.arange(wf, device=dev)).repeat(src)
    d = prox_d
    if n_skip:
        sj = t0 + device_const(skip_offsets, torch.int64, dev)
        si = torch.zeros_like(sj) + (t1 - 1)
        cand_i = torch.cat([cand_i, si])
        cand_j = torch.cat([cand_j, sj])
        # the host drops non-positive skip targets (graph.py:934)
        d = torch.cat([d[:src * wf], torch.where(sj <= 0, INF, d[src * wf:])])

    # NMS seeds: post-retirement actives + bad + inactive, INCLUDING the
    # just-retired edges (they are in ii_inac by selection time on the host)
    sel_ii, sel_jj, sel_m = select_proximity_edges(
        d, cand_i, cand_j, torch.cat([ii, bad_ii, ii_i, ii]), torch.cat([jj, bad_jj, jj_i, jj]),
        torch.cat([keep1, bad_valid, i_valid, stale]), t0, torch.clamp(t1p, min=0), t1, thresh,
        src=src, win=wf, n_skip=n_skip, rad=rad, nms=nms, max_factors=max_factors,
        max_out=max_out)

    # ---- 3. dedup (graph.add_factors): against active (kept) and inactive
    # (+ just retired), and within the new list (first occurrence wins)
    def pair_in(a2, b2, m2):
        return torch.any((sel_ii[:, None] == a2[None, :]) & (sel_jj[:, None] == b2[None, :])
                         & m2[None, :], dim=1)

    in_active = pair_in(ii, jj, keep1)
    in_inac = pair_in(ii_i, jj_i, i_valid) | pair_in(ii, jj, stale)
    same = (sel_ii[:, None] == sel_ii[None, :]) & (sel_jj[:, None] == sel_jj[None, :]) \
        & sel_m[None, :]
    dup_within = torch.any(torch.tril(same, diagonal=-1), dim=1)
    new_m = sel_m & ~in_active & ~in_inac & ~dup_within
    n_new = new_m.long().sum()

    # ---- 4. age-ranked budget eviction (graph.add_factors): evict the
    # oldest actives beyond the budget, retiring them too.  Kept rows hold
    # ranks 0..n1-1 in the host's relative order (padding sorts last).
    n1 = keep1.long().sum()
    do_evict = (n1 + n_new > max_factors) & (n1 > 0) & (max_factors > 0)
    order_key = torch.where(keep1, age, 2 ** 30)
    order = torch.argsort(order_key, stable=True)
    ar_e = torch.arange(E, device=dev)
    ranks = torch.zeros(E, dtype=torch.int64, device=dev).index_put_((order,), ar_e)
    evict = do_evict & keep1 & (ranks >= torch.clamp(max_factors - n_new, min=0))
    keep2 = keep1 & ~evict

    # ---- 5. the new active set: kept (in order) then new (in order)
    pos_k, n_keep = _stable_compact(keep2)
    cap_left = E - n_keep
    pos_n, _ = _stable_compact(new_m)
    take_new = new_m & (pos_n < cap_left)
    kslot = torch.where(keep2, pos_k, E)
    perm = _scatter(E, kslot, ar_e)
    ii2 = _scatter(E, kslot, ii)
    jj2 = _scatter(E, kslot, jj)
    age2 = _scatter(E, kslot, age)
    sel_slots = torch.where(take_new, n_keep + pos_n, E)
    ii2 = _scatter_into(ii2, sel_slots, sel_ii)
    jj2 = _scatter_into(jj2, sel_slots, sel_jj)
    n_total = n_keep + take_new.long().sum()
    valid2 = ar_e < n_total
    is_new = (ar_e >= n_keep) & valid2

    # ---- inactive composition: concat(prior, stale, evicted), keep the LAST I
    n_i = i_valid.long().sum()
    pos_s, n_s = _stable_compact(stale)
    pos_e, _ = _stable_compact(evict)
    total = n_i + n_s + evict.long().sum()
    drop = torch.clamp(total - I, min=0)
    pos_i, _ = _stable_compact(i_valid)
    slot_prior = torch.where(i_valid, pos_i - drop, -1)
    slot_stale = torch.where(stale, n_i + pos_s - drop, -1)
    slot_evict = torch.where(evict, n_i + n_s + pos_e - drop, -1)

    ok_p = i_valid & (slot_prior >= 0)
    p_slot = torch.where(ok_p, slot_prior, I)
    ar_i = torch.arange(I, device=dev)
    perm_old = _scatter(I, p_slot, ar_i)
    ii_i2 = _scatter(I, p_slot, ii_i)
    jj_i2 = _scatter(I, p_slot, jj_i)
    from_act = torch.zeros(I, dtype=torch.bool, device=dev)
    act_idx = torch.zeros(I, dtype=torch.int64, device=dev)
    for flags, slots in ((stale, slot_stale), (evict, slot_evict)):
        tgt = torch.where(flags & (slots >= 0), slots, I)
        from_act = _scatter_into(from_act, tgt, torch.ones_like(flags))
        act_idx = _scatter_into(act_idx, tgt, ar_e)
        ii_i2 = _scatter_into(ii_i2, tgt, ii)
        jj_i2 = _scatter_into(jj_i2, tgt, jj)
    i_valid2 = ar_i < torch.clamp(total, max=I)

    return dict(ii=ii2, jj=jj2, age=age2, valid=valid2, perm=perm, is_new=is_new,
                ii_i=ii_i2, jj_i=jj_i2, i_valid=i_valid2, inact_perm_old=perm_old,
                inact_from_act=from_act, inact_act_idx=act_idx)


def cull_transition(ii, jj, age, e_valid, ii_i, jj_i, i_valid, ix):
    """Edge re-indexing for a culled keyframe (graph.rm_keyframe): drops
    edges touching slot ``ix`` (no retirement), decrements indices above it
    and compacts both stores in order.  Returns the new index state plus
    gather plans (perm for ``_rebuild_edges`` with is_new all False;
    perm_old for ``_rebuild_inactive`` with no active-sourced rows)."""
    E = ii.shape[0]
    I = ii_i.shape[0]
    dev = ii.device

    keep = e_valid & ~((ii == ix) | (jj == ix))
    pos, n_keep = _stable_compact(keep)
    tgt = torch.where(keep, pos, E)
    ar_e = torch.arange(E, device=dev)

    keep_i = i_valid & ~((ii_i == ix) | (jj_i == ix))
    pos_i, n_ki = _stable_compact(keep_i)
    tgt_i = torch.where(keep_i, pos_i, I)
    ar_i = torch.arange(I, device=dev)
    dec = lambda a: torch.where(a >= ix, a - 1, a)  # noqa: E731

    return dict(
        ii=_scatter(E, tgt, dec(ii)), jj=_scatter(E, tgt, dec(jj)),
        age=_scatter(E, tgt, age), valid=ar_e < n_keep, perm=_scatter(E, tgt, ar_e),
        ii_i=_scatter(I, tgt_i, dec(ii_i)), jj_i=_scatter(I, tgt_i, dec(jj_i)),
        i_valid=ar_i < n_ki, inact_perm_old=_scatter(I, tgt_i, ar_i),
    )
