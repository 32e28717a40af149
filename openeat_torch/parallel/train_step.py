"""Training and evaluation steps (PyTorch, one device). Port of
openeat_tpu/parallel/train_step.py:build_train_step and build_eval_step.

One step, in the JAX order:
- gradient accumulation over a batch laid out [accum, micro, ...]: each
  micro-batch's gradient is added up, then divided by accum, and the
  metrics are the micro-batches' mean;
- one flat global norm over every gradient, and the clip
  scale = min(1, grad_clip / max(gnorm, 1e-12)) (not
  torch.nn.utils.clip_grad_norm_, which adds 1e-6 to the norm);
- a non-finite norm skips the update: parameters, Adam's moments and its
  step count stay as they were, but the state's step still counts it;
- the learning rate is schedule(count of applied updates), as optax
  evaluates its schedule (0 on the first update).

A parameter that no loss term reaches gets a zero gradient, as jax.grad
gives, so that Adam treats it as optax does. Whether the norm is finite
is read on the host, one sync per step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from openeat_torch.modules.dropout import set_generator


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0        # steps taken, applied or skipped
    n_applied: int = 0   # updates applied; drives the learning rate


def _loss_and_grads(model: nn.Module, batch: dict, accum_grad: int
                    ) -> dict[str, torch.Tensor]:
    keys = ("features", "features_length", "targets", "targets_length")
    micro = ([batch] if accum_grad == 1 else
             [{k: batch[k][i] for k in keys} for i in range(accum_grad)])
    sums: dict[str, torch.Tensor] = {}
    for mb in micro:
        metrics = model(mb["features"], mb["features_length"],
                        mb["targets"], mb["targets_length"])
        metrics["loss"].backward()
        for k, v in metrics.items():
            v = v.detach().float()
            sums[k] = sums[k] + v if k in sums else v
    if accum_grad > 1:
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(accum_grad)
    return {k: v / accum_grad for k, v in sums.items()}


def apply_update(state: TrainState, schedule: Callable[[int], float],
                 grad_clip: float) -> tuple[torch.Tensor, bool]:
    """Clip the gradients the parameters hold and take the optimizer
    step, or skip it on a non-finite norm. Returns (norm, applied)."""
    params = [p for p in state.model.parameters() if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    gnorm = torch.stack([g.float().square().sum()
                         for g in grads]).sum().sqrt()
    finite = bool(torch.isfinite(gnorm))
    if finite:
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        torch._foreach_mul_(grads, scale)
        for group in state.optimizer.param_groups:
            group["lr"] = schedule(state.n_applied)
        state.optimizer.step()
        state.n_applied += 1
    state.step += 1
    return gnorm.detach(), finite


def build_train_step(schedule: Callable[[int], float], accum_grad: int = 1,
                     grad_clip: float = 5.0) -> Callable:
    """Returns train_step(state, batch, generator) -> metrics dict.

    With accum_grad > 1 every batch array has a leading [accum_grad,
    micro, ...] layout. `generator` feeds the model's dropout."""

    def train_step(state: TrainState, batch: dict,
                   generator: torch.Generator | None) -> dict:
        model = state.model
        model.train()
        set_generator(model, generator)
        state.optimizer.zero_grad(set_to_none=True)
        metrics = _loss_and_grads(model, batch, accum_grad)
        gnorm, applied = apply_update(state, schedule, grad_clip)
        metrics["grad_norm"] = gnorm
        metrics["skipped"] = torch.tensor(0.0 if applied else 1.0)
        return metrics

    return train_step


def build_eval_step(model: nn.Module) -> Callable:
    @torch.no_grad()
    def eval_step(batch: dict) -> dict:
        model.eval()
        return model(batch["features"], batch["features_length"],
                     batch["targets"], batch["targets_length"])
    return eval_step
