"""Global CMVN layer (PyTorch): (x - mean) * istd with fixed statistics.
Port of openeat_tpu/modules/cmvn.py.

The statistics are parameters with gradients, as the JAX package's are
leaves of its parameter tree: the train step counts their gradients in
the clip norm and the non-finite skip, and the optimizer never updates
them (openeat_torch/utils/optim.py:trainable)."""

from __future__ import annotations

import torch
from torch import nn

from openeat_torch.utils.weight_mirror import at_compute


class GlobalCMVN(nn.Module):
    def __init__(self, dim: int, norm_var: bool = True):
        super().__init__()
        self.mean = nn.Parameter(torch.zeros(dim))
        self.istd = nn.Parameter(torch.ones(dim))
        self.norm_var = norm_var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x - at_compute(self.mean, x.dtype)
        if self.norm_var:
            out = out * at_compute(self.istd, x.dtype)
        return out
