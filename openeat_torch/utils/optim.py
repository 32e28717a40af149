"""Optimizer construction with parameter freezing. Port of
openeat_tpu/utils/optim.py: Adam, AdamW or SGD through torch.optim
(optax's defaults: betas 0.9/0.999, eps 1e-8; AdamW's weight decay 0.0
unless given, as the JAX build_optimizer passes it), with the WarmupLR
schedule. Gradient clipping and the non-finite skip live in the train
step (openeat_torch/parallel/train_step.py), as in the JAX package.

Freezing follows the JAX freeze mask by parameter name: GlobalCMVN's
statistics are never trained, and with only_adapter only the
parameters whose name contains "adapter" are. A frozen parameter still
gets its gradient, as every leaf does under jax.grad, so the train
step's global norm counts it; it is only left out of the optimizer,
where the JAX mask zeroes its update.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from openeat_torch.utils.scheduler import warmup_lr


def trainable(name: str, only_adapter: bool = False) -> bool:
    """Whether the optimizer updates the parameter `name` (the JAX
    freeze_mask's rule on the port's dotted names)."""
    if "global_cmvn" in name:
        return False
    return "adapter" in name if only_adapter else True


def build_optimizer(model: nn.Module, lr: float, warmup_steps: int,
                    optim: str = "adam", weight_decay: float = 0.0,
                    only_adapter: bool = False
                    ) -> tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """Returns (optimizer, schedule) over the model's trainable
    parameters. The optimizer's lr is set by the train step from
    schedule(applied updates) before every update."""
    schedule = warmup_lr(lr, warmup_steps)
    params = [p for n, p in model.named_parameters()
              if trainable(n, only_adapter)]
    if not params:
        raise ValueError("no trainable parameters (only_adapter on a model "
                         "without adapters?)")
    lr0 = schedule(0)
    if optim == "adam":
        opt = torch.optim.Adam(params, lr=lr0, betas=(0.9, 0.999), eps=1e-8)
    elif optim == "adamw":
        opt = torch.optim.AdamW(params, lr=lr0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    elif optim == "sgd":
        opt = torch.optim.SGD(params, lr=lr0)
    else:
        raise ValueError(f"unknown optimizer {optim!r}")
    return opt, schedule
