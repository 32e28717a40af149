"""Conformer convolution module (PyTorch, [B, T, C] layout).
Port of openeat_tpu/modules/convolution.py without the streaming cache.

mask -> pointwise_conv1 -> GLU -> pad (causal: K-1 on the left, else
(K-1)/2 on both sides) -> depthwise conv -> LayerNorm (eps 1e-5) ->
activation -> pointwise_conv2 -> mask. The depthwise conv runs through
kernel K3 (openeat_torch/ops/depthwise_conv.py) on the padded
[B, T+K-1, C] input with taps w [K, C]; its bias is added outside the
kernel.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from openeat_torch.modules.layers import Dense, LayerNorm
from openeat_torch.ops.depthwise_conv import depthwise_conv1d


class DepthwiseConv1d(nn.Module):
    """Taps weight [K, C] (K3's layout) and bias [C]."""

    def __init__(self, channels: int, kernel_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(kernel_size, channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.compute_dtype = dtype

    def forward(self, x_padded: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = depthwise_conv1d(x_padded.to(dt).contiguous(),
                             self.weight.to(dt).contiguous())
        return y + self.bias.to(dt)


class ConvolutionModule(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 15,
                 activation: Callable = F.silu, causal: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if not causal and (kernel_size - 1) % 2:
            raise ValueError("non-causal conv needs an odd kernel")
        self.kernel_size = kernel_size
        self.causal = causal
        self.activation = activation
        self.pointwise_conv1 = Dense(channels, 2 * channels, dtype=dtype)
        self.depthwise_conv = DepthwiseConv1d(channels, kernel_size, dtype)
        self.norm = LayerNorm(channels, 1e-5, dtype)
        self.pointwise_conv2 = Dense(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor,
                mask_pad: torch.Tensor | None = None) -> torch.Tensor:
        """x: [B, T, C]; mask_pad: bool [B, 1, T] or [B, T], True = valid."""
        if mask_pad is not None:
            valid = mask_pad.reshape(x.shape[0], -1)[..., None]
            x = torch.where(valid, x, 0.0)
        x = F.glu(self.pointwise_conv1(x), dim=-1)
        if self.causal:
            pad = (self.kernel_size - 1, 0)
        else:
            half = (self.kernel_size - 1) // 2
            pad = (half, half)
        x = F.pad(x, (0, 0) + pad)
        x = self.depthwise_conv(x)
        x = self.pointwise_conv2(self.activation(self.norm(x)))
        if mask_pad is not None:
            x = torch.where(valid, x, 0.0)
        return x
