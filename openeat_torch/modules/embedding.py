"""Positional encodings (PyTorch): absolute and relative sinusoidal, and
none. Port of openeat_tpu/modules/embedding.py; each encoding drops out its
scaled input at positional_dropout_rate (0.0 in the flagship, as in the
reference). `offset` gives the rows from an absolute position on: a
streaming chunk's, or one per stream in a batched chunk step."""

from __future__ import annotations

import math

import torch
from torch import nn

from openeat_torch.modules.dropout import Dropout


def sinusoid_table(length: int, d_model: int, dtype=torch.float32,
                   device=None, offset: int | torch.Tensor = 0
                   ) -> torch.Tensor:
    """[length, d_model] table, row k = pe(offset + k), sin/cos
    interleaved; computed in float32 like the JAX package. A tensor
    offset of shape [B] gives one table per entry, [B, length, d_model].
    Negative positions are finite rows like any other."""
    pos = torch.arange(length, dtype=torch.float32, device=device)
    if isinstance(offset, torch.Tensor) and offset.dim() == 1:
        pos = pos[None, :] + offset.to(device=device,
                                       dtype=torch.float32)[:, None]
    else:
        pos = pos + torch.as_tensor(offset, dtype=torch.float32,
                                    device=device)
    i = torch.arange(d_model // 2, dtype=torch.float32, device=device)
    div = torch.exp(-i * (2.0 / d_model) * math.log(10000.0))
    ang = pos[..., None] * div
    pe = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    return pe.reshape(*pos.shape, d_model).to(dtype)


def _table(x: torch.Tensor, d_model: int,
           offset: int | torch.Tensor) -> torch.Tensor:
    """The table for x [B, T, d] from `offset`: [1, T, d] for a scalar
    offset, [B, T, d] for one offset per row."""
    pe = sinusoid_table(x.shape[1], d_model, x.dtype, x.device, offset)
    return pe if pe.dim() == 3 else pe[None]


class PositionalEncoding(nn.Module):
    """Absolute PE: returns (x*sqrt(d) + pe, pe)."""

    def __init__(self, d_model: int, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, offset: int | torch.Tensor = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
        pe = _table(x, self.d_model, offset)
        return self.dropout(x * self.d_model ** 0.5 + pe), pe


class RelPositionalEncoding(nn.Module):
    """Relative PE: returns (x*sqrt(d), pe); attention reads pe."""

    def __init__(self, d_model: int, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, offset: int | torch.Tensor = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
        pe = _table(x, self.d_model, offset)
        return self.dropout(x * self.d_model ** 0.5), pe


class NoPositionalEncoding(nn.Module):
    """No position: returns (dropout(x), zeros [1, T, d])."""

    def __init__(self, d_model: int, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, offset: int | torch.Tensor = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
        pe = torch.zeros((1, x.shape[1], self.d_model), dtype=x.dtype,
                         device=x.device)
        return self.dropout(x), pe


POS_ENC_CLASSES = {
    "abs_pos": PositionalEncoding,
    "rel_pos": RelPositionalEncoding,
    "no_pos": NoPositionalEncoding,
}
