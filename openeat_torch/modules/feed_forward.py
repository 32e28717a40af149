"""Position-wise feed-forward block (PyTorch).
Port of openeat_tpu/modules/feed_forward.py:PositionwiseFeedForward
(linear -> activation -> dropout -> linear)."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from openeat_torch.modules.dropout import Dropout
from openeat_torch.modules.layers import Dense


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_model: int, hidden_units: int,
                 activation: Callable, dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.w_1 = Dense(d_model, hidden_units, dtype=dtype)
        self.w_2 = Dense(hidden_units, d_model, dtype=dtype)
        self.activation = activation
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_2(self.dropout(self.activation(self.w_1(x))))

