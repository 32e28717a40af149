"""Input layers (PyTorch): the linear projection and the conv2d x4, x6
and x8 subsamplings. Port of openeat_tpu/modules/subsampling.py.

Each returns (x [B, T', d], pos_emb, lengths [B]) and names its rate
(`subsampling_rate`) and the frames it looks ahead (`right_context`).
The JAX modules convolve in NHWC and flatten [B, T', F', C] with the
feature axis major and channels minor into Dense_0 [F'*C, d]. Here the
convolutions run in PyTorch's NCHW and the result is permuted back to
[B, T', F', C] before the flatten, so Dense_0 sees the JAX order and its
weight converts by a plain transpose.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from openeat_torch.modules.dropout import Dropout
from openeat_torch.modules.layers import Conv2d, Dense, LayerNorm


def conv_out_len(lengths, kernel: int, stride: int):
    """Valid-conv output length: floor((L - kernel) / stride) + 1, of an
    int or a tensor of lengths."""
    if isinstance(lengths, torch.Tensor):
        return torch.div(lengths - kernel, stride,
                         rounding_mode="floor") + 1
    return (lengths - kernel) // stride + 1


class LinearNoSubsampling(nn.Module):
    """Dense_0 -> LayerNorm_0 (eps 1e-5) -> dropout -> positional
    encoding; rate 1."""

    subsampling_rate = 1
    right_context = 0

    def __init__(self, input_size: int, d_model: int, pos_enc: nn.Module,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.Dense_0 = Dense(input_size, d_model, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(d_model, 1e-5, dtype)
        self.dropout = Dropout(dropout_rate)
        self.pos_enc = pos_enc

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                offset: int | torch.Tensor = 0):
        h = self.dropout(self.LayerNorm_0(self.Dense_0(x)))
        h, pos_emb = self.pos_enc(h, offset)
        return h, pos_emb, lengths


class Conv2dSubsampling(nn.Module):
    """Conv_0 .. Conv_{n-1} (each followed by a ReLU, valid padding) ->
    Dense_0 -> positional encoding. `convs` lists (kernel, stride)."""

    convs: tuple[tuple[int, int], ...] = ()
    subsampling_rate = 1
    right_context = 0

    def __init__(self, input_size: int, d_model: int, pos_enc: nn.Module,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        f = input_size
        for i, (k, s) in enumerate(self.convs):
            self.add_module(f"Conv_{i}", Conv2d(1 if i == 0 else d_model,
                                                d_model, k, s, dtype))
            f = conv_out_len(f, k, s)
        self.Dense_0 = Dense(f * d_model, d_model, dtype=dtype)
        self.pos_enc = pos_enc

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                offset: int | torch.Tensor = 0):
        """x: [B, T, F] -> (x [B, T', d], pos_emb [1, T', d], lens [B]);
        the positional rows start at `offset` (a tensor [B]: one start
        per row, and pos_emb [B, T', d])."""
        h = x[:, None]
        for i, (k, s) in enumerate(self.convs):
            h = F.relu(getattr(self, f"Conv_{i}")(h))
            lengths = conv_out_len(lengths, k, s)
        b, c, t, f = h.shape                         # [B, C, T', F']
        h = h.permute(0, 2, 3, 1).reshape(b, t, f * c)
        h, pos_emb = self.pos_enc(self.Dense_0(h), offset)
        return h, pos_emb, lengths


class Conv2dSubsampling4(Conv2dSubsampling):
    """Two 3x3 stride-2 convolutions; rate 4."""

    convs = ((3, 2), (3, 2))
    subsampling_rate = 4
    right_context = 6


class Conv2dSubsampling6(Conv2dSubsampling):
    """A 3x3 stride-2 then a 5x5 stride-3 convolution; rate 6."""

    convs = ((3, 2), (5, 3))
    subsampling_rate = 6
    right_context = 10


class Conv2dSubsampling8(Conv2dSubsampling):
    """Three 3x3 stride-2 convolutions; rate 8."""

    convs = ((3, 2), (3, 2), (3, 2))
    subsampling_rate = 8
    right_context = 14


SUBSAMPLE_CLASSES = {
    "linear": LinearNoSubsampling,
    "conv2d": Conv2dSubsampling4,
    "conv2d6": Conv2dSubsampling6,
    "conv2d8": Conv2dSubsampling8,
}
