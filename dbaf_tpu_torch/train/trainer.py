"""Training step: unrolled forward + losses + AdamW update (port of
``dbaf_tpu/train/trainer.py``, single device).

The optimizer is written to optax's formulas so that one step of the port
matches one step of the JAX package: ``torch.optim.AdamW`` (optax's
``adamw`` is the same update), a learning rate that reproduces
``optax.linear_onecycle_schedule`` with the JAX package's segment guards,
and a global-norm clip that scales by ``max / norm`` (optax's
``clip_by_global_norm``; ``clip_grad_norm_`` adds 1e-6 to the norm).
Where the JAX step vmaps over the batch of tuples, the port loops.

On a ``(dp, edge)`` mesh (``parallel/mesh.make_mesh_2d``) each rank holds
its dp row's tuples and, of each, its edge column's share of the edges
(:func:`shard_batch`); the collectives of the unroll make the losses the
same on every rank of an edge group.  Every rank backpropagates its loss
scaled by 1/ranks, the gradients are summed over the edge and then the dp
group (``parallel/collectives.py`` says why that is the mean gradient),
and each rank then takes the same clipped AdamW step, so the parameters
and the optimizer state stay replicated.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models.net import DroidNet
from ..parallel.collectives import all_reduce_, all_sum_packed, group_size
from . import losses
from .unroll import forward

# loss weights of the reference training recipe (DROID-SLAM train.py:
# w1 geodesic, w2 residual, w3 flow)
W_POSE, W_RES, W_FLOW = 10.0, 0.01, 0.05


def onecycle_lr(step: int, lr: float, total_steps: int) -> float:
    """The JAX package's learning rate at optimizer step ``step`` (0-based):
    ``optax.linear_onecycle_schedule`` with ``pct_start``/``pct_final``
    chosen so that each of its three segments is at least one step long,
    and a constant ``lr`` below 3 steps (a shorter segment would make the
    interpolation divide by zero)."""
    if total_steps < 3:
        return float(lr)
    pct_start = max(0.01, 1.0 / total_steps)
    pct_final = min(max(0.7, pct_start + 1.0 / total_steps), 1.0 - 1.0 / total_steps)
    div_factor, final_div_factor = 25.0, 1e4
    # optax.piecewise_interpolate_schedule('linear', lr / div_factor, {...})
    scales = {int(pct_start * total_steps): div_factor,
              int(pct_final * total_steps): 1.0 / div_factor,
              total_steps: 1.0 / final_div_factor}
    boundaries, factors = zip(*sorted(scales.items()))
    bounds = np.asarray((0,) + boundaries)
    values = np.cumprod(np.asarray((lr / div_factor,) + factors))
    indicator = (bounds[:-1] <= step) & (step < bounds[1:])
    pct = (step - bounds[:-1]) / (bounds[1:] - bounds[:-1])
    interp = pct * (values[1:] - values[:-1]) + values[:-1]
    return float(indicator.dot(interp) + (bounds[-1] <= step) * values[-1])


def clip_by_global_norm_(params: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` on the gradients, in place: where the
    global norm reaches ``max_norm`` every gradient is scaled by
    ``max_norm / norm``.  Returns the norm (a 0-d tensor, no host read)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class Optimizer(NamedTuple):
    """AdamW, its learning-rate schedule and the clip threshold."""
    adamw: torch.optim.AdamW
    schedule: torch.optim.lr_scheduler.LambdaLR
    clip: float

    def step(self) -> torch.Tensor:
        """Clip the gradients, step AdamW, advance the schedule; returns
        the gradients' global norm before the clip."""
        norm = clip_by_global_norm_(self.adamw.param_groups[0]["params"], self.clip)
        self.adamw.step()
        self.schedule.step()
        return norm


def make_optimizer(params, lr: float = 2.5e-4, total_steps: int = 250_000,
                   clip: float = 2.5) -> Optimizer:
    """AdamW (weight decay 1e-5) + the one-cycle schedule of
    :func:`onecycle_lr` + global-norm clip, over ``params`` (an iterable
    of tensors, e.g. ``model.parameters()``)."""
    adamw = torch.optim.AdamW(list(params), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-5)
    sched = torch.optim.lr_scheduler.LambdaLR(
        adamw, lambda k: onecycle_lr(k, lr, total_steps) / lr)
    return Optimizer(adamw, sched, clip)


def loss_sample(model: DroidNet, sample: Dict[str, torch.Tensor], num_steps: int,
                fixedp: int = 2, group=None):
    """Loss of ONE covisible tuple (dict of tensors, leading dim = frames
    except ii/jj, which are per edge: this rank's share of them with a
    process ``group``)."""
    poses_list, disps_list, residuals = forward(
        model, sample["images"], sample["poses0"], sample["disps0"], sample["intrinsics"],
        sample["ii"], sample["jj"], num_steps=num_steps, fixedp=fixedp, group=group)
    lg, pm = losses.geodesic_loss(sample["poses_gt"], poses_list, sample["ii"], sample["jj"],
                                  group=group)
    lr_, _ = losses.residual_loss(residuals, group=group)
    lf, fm = losses.flow_loss(sample["poses_gt"], sample["disps_gt"], poses_list,
                              [d[:, 3::8, 3::8] for d in disps_list], sample["intrinsics"])
    loss = W_POSE * lg + W_RES * lr_ + W_FLOW * lf
    metrics = {"loss": loss, "geodesic": lg, "residual": lr_, "flow": lf}
    metrics.update(pm)
    metrics.update(fm)
    return loss, metrics


def _sum_gradients(params: Sequence[torch.Tensor], groups) -> None:
    """In place: every gradient summed over each group in turn, in one
    collective a group (the gradients flattened together)."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    for g in groups:
        all_reduce_(flat, g)
    k = 0
    for g in grads:
        g.copy_(flat[k:k + g.numel()].reshape(g.shape))
        k += g.numel()


def make_train_step(model: DroidNet, opt: Optimizer, num_steps: int = 12, fixedp: int = 2,
                    mesh: Optional[object] = None, dp_axis: str = "dp",
                    edge_axis: str = "edge") -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """``step(batch) -> metrics`` over a batch dict with a leading tuple
    dimension B: the mean loss over the B tuples, one backward pass and one
    optimizer step, in place on ``model``.  Metrics are the batch means,
    0-d tensors on the model's device.

    With ``mesh`` (a ``(dp, edge)`` DeviceMesh), ``batch`` is this rank's
    share (:func:`shard_batch`), and the step and its metrics are those of
    the whole batch, the same on every rank."""
    dp_group = edge_group = None
    if mesh is not None:
        # an axis of one rank needs no collective: its group stays None
        names = mesh.mesh_dim_names
        dp_group, edge_group = (mesh.get_group(a) if mesh.size(names.index(a)) > 1 else None
                                for a in (dp_axis, edge_axis))
    ranks = group_size(dp_group) * group_size(edge_group)
    params = [p for g in opt.adamw.param_groups for p in g["params"]]

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        B = next(iter(batch.values())).shape[0]
        opt.adamw.zero_grad(set_to_none=True)
        per = [loss_sample(model, {k: v[b] for k, v in batch.items()}, num_steps, fixedp,
                           edge_group) for b in range(B)]
        loss = torch.stack([lo for lo, _ in per]).mean()
        if ranks == 1:
            loss.backward()
        else:
            (loss / ranks).backward()
            _sum_gradients(params, [g for g in (edge_group, dp_group) if g is not None])
        opt.step()
        names = list(per[0][1])
        means = [torch.stack([torch.as_tensor(m[k]) for _, m in per]).mean().detach()
                 for k in names]
        if dp_group is not None:
            n_dp = group_size(dp_group)
            means = [m / n_dp for m in all_sum_packed([m.float() for m in means], dp_group)]
        return dict(zip(names, means))

    return step


_EDGE_KEYS = ("ii", "jj", "targets")


def shard_batch(batch: Dict, mesh, dp_axis: str = "dp", edge_axis: str = "edge",
                device=None) -> Dict[str, torch.Tensor]:
    """This rank's share of a host batch dict (leading tuple dimension B):
    its dp row's B / dp tuples, and of the per-edge arrays (``ii``, ``jj``,
    ``targets``: (B, E, ...)) its edge column's E / edge edges, on the
    rank's device (:func:`dbaf_tpu_torch.parallel.dist.rank_device`)."""
    from ..parallel.dist import rank_device

    dev = rank_device(device)
    n_dp, n_edge = mesh.size(mesh.mesh_dim_names.index(dp_axis)), \
        mesh.size(mesh.mesh_dim_names.index(edge_axis))
    d, e = mesh.get_local_rank(dp_axis), mesh.get_local_rank(edge_axis)
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
        B = v.shape[0]
        if B % n_dp:
            raise ValueError(f"batch of {B} tuples does not divide the dp axis ({n_dp})")
        v = v[d * (B // n_dp):(d + 1) * (B // n_dp)]
        if k in _EDGE_KEYS:
            E = v.shape[1]
            if E % n_edge:
                raise ValueError(f"{E} edges do not divide the edge axis ({n_edge})")
            v = v[:, e * (E // n_edge):(e + 1) * (E // n_edge)]
        out[k] = v.to(dev)
    return out
