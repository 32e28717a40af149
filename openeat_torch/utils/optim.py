"""Optimizer construction. Port of openeat_tpu/utils/optim.py: Adam,
AdamW or SGD through torch.optim (optax's defaults: betas 0.9/0.999,
eps 1e-8; AdamW's weight decay 0.0 unless given, as the JAX
build_optimizer passes it), with the WarmupLR schedule. Gradient clipping and the non-finite skip live in the train
step (openeat_torch/parallel/train_step.py), as in the JAX package.

Only parameters with requires_grad are optimized: GlobalCMVN's
statistics are frozen (requires_grad=False), as the JAX package masks
them. Adapter-only fine-tuning comes with a later slice.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from openeat_torch.utils.scheduler import warmup_lr


def build_optimizer(model: nn.Module, lr: float, warmup_steps: int,
                    optim: str = "adam", weight_decay: float = 0.0
                    ) -> tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """Returns (optimizer, schedule). The optimizer's lr is set by the
    train step from schedule(applied updates) before every update."""
    schedule = warmup_lr(lr, warmup_steps)
    params = [p for p in model.parameters() if p.requires_grad]
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
