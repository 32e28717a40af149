"""Conv2d x4 input subsampling (PyTorch).
Port of openeat_tpu/modules/subsampling.py:Conv2dSubsampling4.

The JAX module convolves in NHWC and flattens [B, T', F', C] with the
feature axis major and channels minor into Dense_0 [F'*C, d]. Here the
convolutions run in PyTorch's NCHW and the result is permuted back to
[B, T', F', C] before the flatten, so Dense_0 sees the JAX order and its
weight converts by a plain transpose.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from openeat_torch.modules.layers import Conv2d, Dense


def conv_out_len(lengths: torch.Tensor, kernel: int,
                 stride: int) -> torch.Tensor:
    """Valid-conv output length: floor((L - kernel) / stride) + 1."""
    return torch.div(lengths - kernel, stride, rounding_mode="floor") + 1


class Conv2dSubsampling4(nn.Module):
    subsampling_rate = 4

    def __init__(self, input_size: int, d_model: int, pos_enc: nn.Module,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv2d(1, d_model, 3, 2, dtype)
        self.Conv_1 = Conv2d(d_model, d_model, 3, 2, dtype)
        f = ((input_size - 1) // 2 - 1) // 2
        self.Dense_0 = Dense(f * d_model, d_model, dtype=dtype)
        self.pos_enc = pos_enc

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                offset: int | torch.Tensor = 0):
        """x: [B, T, F] -> (x [B, T', d], pos_emb [1, T', d], lens [B]);
        the positional rows start at `offset` (a tensor [B]: one start
        per row, and pos_emb [B, T', d])."""
        h = F.relu(self.Conv_0(x[:, None]))
        h = F.relu(self.Conv_1(h))                  # [B, C, T', F']
        b, c, t, f = h.shape
        h = h.permute(0, 2, 3, 1).reshape(b, t, f * c)
        h, pos_emb = self.pos_enc(self.Dense_0(h), offset)
        new_len = conv_out_len(conv_out_len(lengths, 3, 2), 3, 2)
        return h, pos_emb, new_len
