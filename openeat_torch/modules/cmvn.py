"""Global CMVN layer (PyTorch): (x - mean) * istd with fixed statistics.
Port of openeat_tpu/modules/cmvn.py.

The statistics are parameters with gradients, as the JAX package's are
leaves of its parameter tree: the train step counts their gradients in
the clip norm and the non-finite skip, and the optimizer never updates
them (openeat_torch/utils/optim.py:trainable)."""

from __future__ import annotations

import torch
from torch import nn


class GlobalCMVN(nn.Module):
    def __init__(self, dim: int, norm_var: bool = True):
        super().__init__()
        self.mean = nn.Parameter(torch.zeros(dim))
        self.istd = nn.Parameter(torch.ones(dim))
        self.norm_var = norm_var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x - self.mean.to(x.dtype)
        if self.norm_var:
            out = out * self.istd.to(x.dtype)
        return out
