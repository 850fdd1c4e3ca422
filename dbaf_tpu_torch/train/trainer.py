"""Training step: unrolled forward + losses + AdamW update (port of
``dbaf_tpu/train/trainer.py``, single device).

The optimizer is written to optax's formulas so that one step of the port
matches one step of the JAX package: ``torch.optim.AdamW`` (optax's
``adamw`` is the same update), a learning rate that reproduces
``optax.linear_onecycle_schedule`` with the JAX package's segment guards,
and a global-norm clip that scales by ``max / norm`` (optax's
``clip_by_global_norm``; ``clip_grad_norm_`` adds 1e-6 to the norm).
Where the JAX step vmaps over the batch of tuples, the port loops.  The
mesh-sharded step is not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models.net import DroidNet
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
                fixedp: int = 2):
    """Loss of ONE covisible tuple (dict of tensors, leading dim = frames
    except ii/jj, which are per edge)."""
    poses_list, disps_list, residuals = forward(
        model, sample["images"], sample["poses0"], sample["disps0"], sample["intrinsics"],
        sample["ii"], sample["jj"], num_steps=num_steps, fixedp=fixedp)
    lg, pm = losses.geodesic_loss(sample["poses_gt"], poses_list, sample["ii"], sample["jj"])
    lr_, _ = losses.residual_loss(residuals)
    lf, fm = losses.flow_loss(sample["poses_gt"], sample["disps_gt"], poses_list,
                              [d[:, 3::8, 3::8] for d in disps_list], sample["intrinsics"])
    loss = W_POSE * lg + W_RES * lr_ + W_FLOW * lf
    metrics = {"loss": loss, "geodesic": lg, "residual": lr_, "flow": lf}
    metrics.update(pm)
    metrics.update(fm)
    return loss, metrics


def make_train_step(model: DroidNet, opt: Optimizer, num_steps: int = 12, fixedp: int = 2,
                    mesh: Optional[object] = None) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """``step(batch) -> metrics`` over a batch dict with a leading tuple
    dimension B: the mean loss over the B tuples, one backward pass and one
    optimizer step, in place on ``model``.  Metrics are the batch means,
    0-d tensors on the model's device."""
    if mesh is not None:
        raise NotImplementedError(
            "dbaf_tpu_torch: the mesh-sharded training step (ROADMAP Queue 1 item 8) is not "
            "ported yet")

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        B = next(iter(batch.values())).shape[0]
        opt.adamw.zero_grad(set_to_none=True)
        per = [loss_sample(model, {k: v[b] for k, v in batch.items()}, num_steps, fixedp)
               for b in range(B)]
        loss = torch.stack([lo for lo, _ in per]).mean()
        loss.backward()
        opt.step()
        return {k: torch.stack([torch.as_tensor(m[k]) for _, m in per]).mean().detach()
                for k in per[0][1]}

    return step
