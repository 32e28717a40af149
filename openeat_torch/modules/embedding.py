"""Sinusoidal positional encodings (PyTorch).
Port of openeat_tpu/modules/embedding.py; each encoding drops out its
scaled input at positional_dropout_rate (0.0 in the flagship, as in the
reference)."""

from __future__ import annotations

import math

import torch
from torch import nn

from openeat_torch.modules.dropout import Dropout


def sinusoid_table(length: int, d_model: int, dtype=torch.float32,
                   device=None, offset: int = 0) -> torch.Tensor:
    """[length, d_model] table, row k = pe(offset + k), sin/cos
    interleaved; computed in float32 like the JAX package."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None] \
        + float(offset)
    i = torch.arange(d_model // 2, dtype=torch.float32, device=device)[None]
    div = torch.exp(-i * (2.0 / d_model) * math.log(10000.0))
    ang = pos * div
    pe = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    return pe.reshape(length, d_model).to(dtype)


class PositionalEncoding(nn.Module):
    """Absolute PE: returns (x*sqrt(d) + pe, pe)."""

    def __init__(self, d_model: int, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        pe = sinusoid_table(x.shape[1], self.d_model, x.dtype, x.device)[None]
        return self.dropout(x * self.d_model ** 0.5 + pe), pe


class RelPositionalEncoding(nn.Module):
    """Relative PE: returns (x*sqrt(d), pe); attention reads pe."""

    def __init__(self, d_model: int, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        pe = sinusoid_table(x.shape[1], self.d_model, x.dtype, x.device)[None]
        return self.dropout(x * self.d_model ** 0.5), pe


POS_ENC_CLASSES = {
    "abs_pos": PositionalEncoding,
    "rel_pos": RelPositionalEncoding,
}
