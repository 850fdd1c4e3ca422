"""Collectives of the port's sharded paths, on ``torch.distributed``.

Where the JAX package lets GSPMD insert its ``psum`` and ``all_gather``,
the port calls them: :func:`all_sum` and :func:`all_cat` for the
edge-sharded solve and training step, :func:`gather_rows` for the
keyframe-sharded video.  A ``group`` of None is a single process: every
function then returns its input, so the unsharded paths run unchanged.

The differentiable ones follow the SPMD convention of the JAX package's
``shard_map``: a value after a collective is replicated, and every rank
computes the same loss from it.  The backward of a sum is then a sum of
the cotangents (``psum`` transposes to ``psum``) and that of a gather is
a sum followed by the rank's own slice, so a loss computed on each of n
ranks yields n times the gradient of the edges' share: the training step
scales its loss by 1/n before the backward pass and sums the parameters'
gradients over the ranks (:mod:`dbaf_tpu_torch.train.trainer`).
``torch.distributed.nn.functional.all_reduce`` has the same backward,
but is deprecated.

gloo reduces host tensors only: where ranks share one card they use gloo,
and a CUDA tensor then goes through the host (``_staged``).  Gathers move
bytes (a ``uint8`` view), so they are exact for every dtype, bf16
included, on either backend.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In place: the sum of ``t`` over the group (no autograd)."""
    if _staged(t, group):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_first(t: torch.Tensor, group) -> torch.Tensor:
    """A copy of the group's first rank's ``t`` (equal shapes and dtypes on
    every rank), bytes for bytes (no autograd)."""
    flat = t.detach().reshape(-1).contiguous().view(torch.uint8)
    buf = flat.cpu() if _staged(t, group) else flat.clone()
    dist.broadcast(buf, dist.get_global_rank(group, 0), group=group)
    return buf.to(t.device).view(t.dtype).reshape(t.shape)


def all_gather_stack(t: torch.Tensor, group) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t`` (equal shapes), bytes for bytes."""
    n = group_size(group)
    flat = t.contiguous().reshape(-1).view(torch.uint8)
    src = flat.cpu() if _staged(t, group) else flat
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts).to(t.device)
    return out.view(t.dtype).reshape((n,) + tuple(t.shape))


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.detach().clone(), ctx.group), None


class _AllCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        return all_gather_stack(x.detach(), group).reshape((-1,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.detach().contiguous().clone(), ctx.group)
        r = group_rank(ctx.group)
        return g[r * ctx.n:(r + 1) * ctx.n], None


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group, replicated; its backward sums the
    cotangents."""
    return x if group is None else _AllSum.apply(x, group)


def all_cat(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (equal leading sizes) concatenated along dim 0 in
    rank order, replicated; its backward is the rank's slice of the summed
    cotangent."""
    return x if group is None else _AllCat.apply(x, group)


def all_sum_packed(xs: Sequence[torch.Tensor], group) -> Tuple[torch.Tensor, ...]:
    """:func:`all_sum` of several tensors of one dtype in one collective."""
    if group is None:
        return tuple(xs)
    flat = all_sum(torch.cat([x.reshape(-1) for x in xs]), group)
    out, k = [], 0
    for x in xs:
        out.append(flat[k:k + x.numel()].reshape(x.shape))
        k += x.numel()
    return tuple(out)


def all_cat_packed(xs: Sequence[torch.Tensor], group) -> Tuple[torch.Tensor, ...]:
    """:func:`all_cat` of several (E,) integer tensors in one collective."""
    if group is None:
        return tuple(xs)
    g = all_cat(torch.stack(list(xs), dim=1), group)
    return tuple(g[:, k] for k in range(len(xs)))


def gather_rows(local: torch.Tensor, idx: torch.Tensor, group) -> torch.Tensor:
    """Rows ``idx`` of a buffer split over the group in equal contiguous
    blocks, rank r holding rows ``[r n, (r + 1) n)`` as ``local`` (n rows).
    Each rank reads the requested rows it owns, every rank's reads are
    gathered, and each row is taken from its owner: exact, no sum."""
    n = local.shape[0]
    idx = idx.reshape(-1)
    r = group_rank(group)
    mine = local.index_select(0, torch.clamp(idx - r * n, 0, n - 1))
    every = all_gather_stack(mine, group)
    return every[idx // n, torch.arange(idx.numel(), device=idx.device)]


def mean(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The mean of ``x`` over every rank's entries (``torch.mean`` for one
    process)."""
    if group is None:
        return torch.mean(x)
    s = all_sum(torch.stack([torch.sum(x), torch.full((), x.numel(), dtype=x.dtype,
                                                      device=x.device)]), group)
    return s[0] / s[1]
