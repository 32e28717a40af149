"""Basic layers with flax's dtype rule: parameters are stored in float32
and cast, together with the input, to the compute dtype at use.

These stand in for flax.linen's Dense, LayerNorm, Conv and Embed in the
ported modules. Weights are in PyTorch's layout (Linear [out, in], Conv2d
[out, in, kh, kw]); openeat_torch/utils/param_bridge.py converts from
flax's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """Statistics in float32, output in the compute dtype (flax's
    LayerNorm with dtype=compute_dtype)."""

    def __init__(self, dim: int, eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


class Conv2d(nn.Conv2d):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel, stride=stride)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        self.stride)


class Embed(nn.Embedding):
    def __init__(self, num: int, dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num, dim)
        self.compute_dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.compute_dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied output head: x @ embedding^T in the compute dtype."""
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt))
