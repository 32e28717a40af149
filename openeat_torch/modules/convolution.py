"""Conformer convolution module (PyTorch, [B, T, C] layout).
Port of openeat_tpu/modules/convolution.py, with its streaming cache.

mask -> pointwise_conv1 -> GLU -> pad (causal: K-1 on the left, else
(K-1)/2 on both sides) -> depthwise conv -> LayerNorm (eps 1e-5) ->
activation -> pointwise_conv2 -> mask. A streaming chunk of a causal
module passes `cache` [B, K-1, C], the previous chunk's last K-1 GLU
rows: they take the place of the left padding, and the call returns the
chunk's own last K-1 rows as the next cache. The depthwise conv runs
through kernel K3 (openeat_torch/ops/depthwise_conv.py) on the padded
(or cache-led) [B, T+K-1, C] input with taps w [K, C]; its bias is added
outside the kernel. Under sequence parallelism (`sp`) x is the rank's
frames and the halo exchange of openeat_torch/parallel/
tensor_parallel.py takes the padding's place after the GLU: the
neighbours' GLU rows, zeros at the ends, so K3 runs on [B, T/n + K-1,
C] and sees what the unsharded pad gives those rows.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from openeat_torch.modules.layers import Dense, LayerNorm
from openeat_torch.ops.depthwise_conv import depthwise_conv1d
from openeat_torch.parallel import tensor_parallel as tp


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

    @property
    def padding(self) -> tuple[int, int]:
        """Frames of zeros (before, after) the depthwise conv needs."""
        if self.causal:
            return self.kernel_size - 1, 0
        half = (self.kernel_size - 1) // 2
        return half, half

    def forward(self, x: torch.Tensor,
                mask_pad: torch.Tensor | None = None,
                cache: torch.Tensor | None = None,
                sp: tp.TimeShard | None = None):
        """x: [B, T, C]; mask_pad: bool [B, 1, T] or [B, T], True = valid
        (under `sp`: this rank's frames of both). Returns y [B, T, C], or
        (y, new_cache [B, K-1, C]) when `cache` is given (causal modules
        only)."""
        if mask_pad is not None:
            valid = mask_pad.reshape(x.shape[0], -1)[..., None]
            x = torch.where(valid, x, 0.0)
        x = F.glu(self.pointwise_conv1(x), dim=-1)
        new_cache = None
        if cache is not None:
            if not self.causal:
                raise ValueError("a conv cache needs a causal module")
            x = torch.cat([cache.to(x.dtype), x], dim=1)
            # its own tensor: a view would keep the whole chunk alive
            new_cache = x[:, x.shape[1] - (self.kernel_size - 1):].clone()
        elif sp is not None:
            x = tp.halo_exchange(x, *self.padding, sp)
        else:
            x = F.pad(x, (0, 0) + self.padding)
        x = self.depthwise_conv(x)
        x = self.pointwise_conv2(self.activation(self.norm(x)))
        if mask_pad is not None:
            x = torch.where(valid, x, 0.0)
        return x if new_cache is None else (x, new_cache)
