"""Dropout at the exact rate, drawn from a generator the trainer owns.

Port of openeat_tpu/modules/dropout.py. The JAX module draws one random
byte per element and so realises a keep probability rounded to q/256
(rate 0.1 keeps 230/256); this port keeps exactly 1 - rate and scales by
1 / (1 - rate). A mask is drawn only in ``model.train()`` and only from
the ``torch.Generator`` that :func:`set_generator` hands every Dropout
of a model; training without one raises rather than touching the
global RNG.
"""

from __future__ import annotations

import torch
from torch import nn


class Dropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate {rate} not in [0, 1)")
        self.rate = float(rate)
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in training mode needs a generator; "
                               "call openeat_torch.modules.dropout."
                               "set_generator(model, generator)")
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.rate
        scale = 1.0 / (1.0 - self.rate)
        return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def set_generator(model: nn.Module, generator: torch.Generator | None) -> None:
    """Point every Dropout in `model` at `generator`."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
