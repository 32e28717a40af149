"""Global CMVN layer (PyTorch): (x - mean) * istd with fixed statistics.
Port of openeat_tpu/modules/cmvn.py."""

from __future__ import annotations

import torch
from torch import nn


class GlobalCMVN(nn.Module):
    def __init__(self, dim: int, norm_var: bool = True):
        super().__init__()
        self.mean = nn.Parameter(torch.zeros(dim), requires_grad=False)
        self.istd = nn.Parameter(torch.ones(dim), requires_grad=False)
        self.norm_var = norm_var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x - self.mean.to(x.dtype)
        if self.norm_var:
            out = out * self.istd.to(x.dtype)
        return out
