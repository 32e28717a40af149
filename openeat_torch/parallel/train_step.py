"""Training and evaluation steps (PyTorch). Port of
openeat_tpu/parallel/train_step.py:make_loss_fn, build_train_step and
build_eval_step.

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
gives, so that Adam treats it as optax does. Every parameter of the
model gets its gradient, the frozen ones too (GlobalCMVN's statistics;
all but the adapters under only_adapter): the norm, the clip and the
non-finite skip count them, as JAX's flat norm over the whole gradient
tree does, and the optimizer, which holds the trainable parameters
only, leaves them as they are. Whether the norm is finite
is read on the host, one sync per step. A mixture-of-experts model's
`moe_aux` enters the training loss at moe_aux_weight (make_loss_fn's
rule); the eval step leaves it out.

On a mesh (openeat_torch/parallel/mesh.py) each rank's loss is its share
of the global batch's (tensor_parallel.py), and after accumulation one
flat sum all-reduce of every gradient over the data group gives every
rank the global batch's gradient: the JAX step's one psum a step, with
no no_sync. The global norm counts each sharded tensor's shards once
(one all-reduce of the sharded and replicated square sums over the
model group) and each replicated tensor once, so every rank reads the
same norm and skips the same steps. The metrics are summed over the
data group: every rank returns the global batch's. On a pipe mesh
(pipeline.py) each stage's parameters (`pipe_stage`) count on their
rank, a shared layer held by k stages (`pipe_copies`) 1/k on each, and
the replicated ones, equal on every pipe rank, once; the metrics are
already equal on every pipe rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from openeat_torch.modules.dropout import set_generator


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0        # steps taken, applied or skipped
    n_applied: int = 0   # updates applied; drives the learning rate


def asr_metrics(model: nn.Module, batch: dict) -> dict[str, torch.Tensor]:
    """The ASR model's metrics on a batch of its four keys."""
    return model(batch["features"], batch["features_length"],
                 batch["targets"], batch["targets_length"])


def asr_loss(model: nn.Module, batch: dict) -> dict[str, torch.Tensor]:
    """asr_metrics with the MoE aux loss added at moe_aux_weight."""
    metrics = asr_metrics(model, batch)
    if "moe_aux" in metrics:
        metrics["loss"] = metrics["loss"] \
            + model.moe_aux_weight * metrics["moe_aux"]
    return metrics


def reduce_metrics(metrics: dict, mesh) -> dict:
    """Sum each metric over the data group (one all-reduce)."""
    if mesh is None:
        return metrics
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(flat, group=mesh.data_group)
    return dict(zip(keys, flat.unbind()))


def _loss_and_grads(model: nn.Module, batch: dict, accum_grad: int,
                    loss_fn: Callable) -> dict[str, torch.Tensor]:
    micro = ([batch] if accum_grad == 1 else
             [{k: v[i] for k, v in batch.items()}
              for i in range(accum_grad)])
    sums: dict[str, torch.Tensor] = {}
    for mb in micro:
        metrics = loss_fn(model, mb)
        metrics["loss"].backward()
        for k, v in metrics.items():
            v = v.detach().float()
            sums[k] = sums[k] + v if k in sums else v
    if accum_grad > 1:
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(accum_grad)
    return {k: v / accum_grad for k, v in sums.items()}


def _global_norm(params: list, mesh) -> torch.Tensor:
    sq = [p.grad.float().square().sum() for p in params]
    if mesh is None or mesh.tp * mesh.pp == 1:
        return torch.stack(sq).sum().sqrt()
    # a model or pipe group's ranks each hold their own shards or stage,
    # and all of them the replicated tensors
    zero = sq[0].new_zeros(())
    own = [hasattr(p, "tp_dim") or hasattr(p, "pipe_stage") for p in params]
    mine = sum((q / getattr(p, "pipe_copies", 1)
                for q, o, p in zip(sq, own, params) if o), zero)
    replicated = sum((q for q, o in zip(sq, own) if not o), zero)
    group = mesh.model_group if mesh.tp > 1 else mesh.pipe_group
    both = torch.stack([mine, replicated / (mesh.tp * mesh.pp)])
    dist.all_reduce(both, group=group)
    return both.sum().sqrt()


def apply_update(state: TrainState, schedule: Callable[[int], float],
                 grad_clip: float, mesh=None) -> tuple[torch.Tensor, bool]:
    """Sum the gradients the parameters hold over the mesh's data group,
    clip them and take the optimizer step, or skip it on a non-finite
    norm. Returns (norm, applied)."""
    params = [p for p in state.model.parameters() if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    if mesh is not None:
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=mesh.data_group)
        for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(r)
    gnorm = _global_norm(params, mesh)
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
                     grad_clip: float = 5.0,
                     loss_fn: Callable | None = None,
                     mesh=None) -> Callable:
    """Returns train_step(state, batch, generator, chunk_generator=None)
    -> metrics dict.

    With accum_grad > 1 every batch array has a leading [accum_grad,
    micro, ...] layout. `generator` feeds the model's dropout, and its
    dynamic chunk draw unless `chunk_generator` is given.
    `loss_fn(model, batch) -> metrics with "loss"` replaces the ASR loss
    (asr_loss), as the LM trainer does, like the JAX
    build_train_step(..., loss_fn=). On a `mesh` the batch holds this
    rank's rows and the model is the mesh's (apply_mesh)."""
    loss_fn = asr_loss if loss_fn is None else loss_fn

    def train_step(state: TrainState, batch: dict,
                   generator: torch.Generator | None,
                   chunk_generator: torch.Generator | None = None) -> dict:
        model = state.model
        model.train()
        set_generator(model, generator, chunk_generator)
        model.zero_grad(set_to_none=True)
        metrics = _loss_and_grads(model, batch, accum_grad, loss_fn)
        gnorm, applied = apply_update(state, schedule, grad_clip, mesh)
        metrics = reduce_metrics(metrics, mesh)
        metrics["grad_norm"] = gnorm
        metrics["skipped"] = torch.tensor(0.0 if applied else 1.0)
        return metrics

    return train_step


def build_eval_step(model: nn.Module, loss_fn: Callable | None = None,
                    mesh=None) -> Callable:
    """The deterministic forward's metrics (asr_metrics unless loss_fn is
    given), summed over the mesh's data group."""
    loss_fn = asr_metrics if loss_fn is None else loss_fn

    @torch.no_grad()
    def eval_step(batch: dict) -> dict:
        model.eval()
        return reduce_metrics(loss_fn(model, batch), mesh)
    return eval_step
