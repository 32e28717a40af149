"""Transformer decoder block (PyTorch).
Port of openeat_tpu/modules/decoder_layer.py:DecoderLayer.__call__:
pre-norm self-attention -> cross-attention -> FFN, LayerNorm eps 1e-12,
each branch through dropout at dropout_rate before its residual add.
The KV-cache `step` comes with the attention decode mode."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from openeat_torch.modules.attention import MultiHeadedAttention
from openeat_torch.modules.dropout import Dropout
from openeat_torch.modules.feed_forward import PositionwiseFeedForward
from openeat_torch.modules.layers import LayerNorm


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, attention_heads: int, linear_units: int,
                 activation: Callable, dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0,
                 attention_dropout_rate: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(d_model, 1e-12, dtype)
        self.norm2 = LayerNorm(d_model, 1e-12, dtype)
        self.norm3 = LayerNorm(d_model, 1e-12, dtype)
        self.self_attn = MultiHeadedAttention(attention_heads, d_model, dtype,
                                              attention_dropout_rate)
        self.src_attn = MultiHeadedAttention(attention_heads, d_model, dtype,
                                             attention_dropout_rate)
        self.feed_forward = PositionwiseFeedForward(
            d_model, linear_units, activation, dtype, dropout_rate)
        self.drop = Dropout(dropout_rate)

    def forward(self, tgt, tgt_mask, memory, memory_mask):
        """tgt: [B, L, D]; tgt_mask: bool [B, L, L]; memory: [B, T, D];
        memory_mask: bool [B, 1, T]."""
        h = self.norm1(tgt)
        x = tgt + self.drop(self.self_attn(h, h, h, tgt_mask))
        h = self.norm2(x)
        x = x + self.drop(self.src_attn(h, memory, memory, memory_mask))
        return x + self.drop(self.feed_forward(self.norm3(x)))
