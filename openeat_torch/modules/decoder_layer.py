"""Transformer decoder block (PyTorch).
Port of openeat_tpu/modules/decoder_layer.py:DecoderLayer.__call__:
pre-norm self-attention -> cross-attention -> FFN, LayerNorm eps 1e-12,
each branch through dropout at dropout_rate before its residual add;
and the KV-cache `step` of the attention decode mode: self-attention K/V
written into a static [B, Lmax, H, Dk] cache at the position, the
history masked by arange(Lmax) <= pos, cross-attention K/V projected
once per utterance. With use_adapter the fine-tuning Adapter runs in
parallel to the FFN, in `forward` and in `step`, adding only its scaled
update."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from openeat_torch.modules.attention import MultiHeadedAttention
from openeat_torch.modules.dropout import Dropout
from openeat_torch.modules.feed_forward import (Adapter,
                                                PositionwiseFeedForward)
from openeat_torch.modules.layers import LayerNorm


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, attention_heads: int, linear_units: int,
                 activation: Callable, dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0,
                 attention_dropout_rate: float = 0.0,
                 use_adapter: bool = False, down_size: int = 64,
                 scalar: float = 0.1):
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
        if use_adapter:
            self.adapter = Adapter(d_model, dropout_rate, down_size, scalar,
                                   dtype)
        self.use_adapter = use_adapter
        self.drop = Dropout(dropout_rate)

    def forward(self, tgt, tgt_mask, memory, memory_mask):
        """tgt: [B, L, D]; tgt_mask: bool [B, L, L]; memory: [B, T, D];
        memory_mask: bool [B, 1, T]."""
        h = self.norm1(tgt)
        x = tgt + self.drop(self.self_attn(h, h, h, tgt_mask))
        h = self.norm2(x)
        x = x + self.drop(self.src_attn(h, memory, memory, memory_mask))
        adapter_update = self.adapter(x) if self.use_adapter else 0.0
        return x + self.drop(self.feed_forward(self.norm3(x))) \
            + adapter_update

    # ---- incremental decode ----

    def init_cross_cache(self, memory: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """Cross-attention K/V of `memory`, projected once: (k, v), each
        [B, T, H, Dk]."""
        return self.src_attn.project_kv(memory)

    def step(self, x: torch.Tensor, pos: int, self_k: torch.Tensor,
             self_v: torch.Tensor, cross_kv, memory_mask: torch.Tensor):
        """One position. x: [B, 1, D], the embedded token at `pos`;
        self_k/v: [B, Lmax, H, Dk] caches, written at `pos` in place;
        cross_kv from init_cross_cache; memory_mask bool [B, 1, T].
        Returns (y [B, 1, D], self_k, self_v). No dropout."""
        b, lmax = self_k.shape[:2]
        h = self.norm1(x)
        q = self.self_attn.project_q(h)
        k_new, v_new = self.self_attn.project_kv(h)
        self_k[:, pos] = k_new[:, 0]
        self_v[:, pos] = v_new[:, 0]
        hist = (torch.arange(lmax, device=x.device) <= pos)[None, None, :]
        x = x + self.self_attn.attend_cached(q, self_k, self_v,
                                             hist.expand(b, 1, lmax))
        h = self.norm2(x)
        x = x + self.src_attn.attend_cached(self.src_attn.project_q(h),
                                            *cross_kv, memory_mask)
        adapter_update = self.adapter(x) if self.use_adapter else 0.0
        return (x + self.feed_forward(self.norm3(x)) + adapter_update,
                self_k, self_v)
