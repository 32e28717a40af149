"""Multi-head attention: vanilla and Transformer-XL relative-position
(PyTorch). Port of openeat_tpu/modules/attention.py.

Scores are taken in float32, masked positions are filled with -1e9
before the softmax and zeroed after it (a fully masked query row gives
0, not NaN), dropout (rate 0 unless set, as in the JAX modules) acts on
the probabilities, and the rel-pos variant computes (q+u)k^T + (q+v)p^T as one
product over the concatenated 2*d_k contraction, without rel_shift (the
WeNet convention the JAX package keeps). These are plain matmuls: no
Pallas kernel stands behind them in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from openeat_torch.modules.dropout import Dropout
from openeat_torch.modules.layers import Dense

NEG_INF = -1.0e9


def _softmax_context(scores: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor | None,
                     dropout: Dropout) -> torch.Tensor:
    """scores [B, H, Tq, Tk] f32 (already scaled); v [B, H, Tk, D];
    mask bool [B, 1, Tk] or [B, Tq, Tk], True = attend.
    Returns ctx [B, Tq, H*D] in v's dtype."""
    if mask is not None:
        m = mask[:, None]
        scores = scores.masked_fill(~m, NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    if mask is not None:
        attn = attn.masked_fill(~m, 0.0)
    ctx = torch.matmul(dropout(attn.to(v.dtype)), v)
    b, h, t, d = ctx.shape
    return ctx.transpose(1, 2).reshape(b, t, h * d)


class MultiHeadedAttention(nn.Module):
    def __init__(self, num_heads: int, d_model: int,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} % heads {num_heads} != 0")
        self.h = num_heads
        self.d_k = d_model // num_heads
        self.linear_q = Dense(d_model, d_model, dtype=dtype)
        self.linear_k = Dense(d_model, d_model, dtype=dtype)
        self.linear_v = Dense(d_model, d_model, dtype=dtype)
        self.linear_out = Dense(d_model, d_model, dtype=dtype)
        self.attn_dropout = Dropout(dropout_rate)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, H*D] -> [B, H, T, D]."""
        return x.view(x.shape[0], x.shape[1], self.h, self.d_k).transpose(1, 2)

    def forward(self, query, key, value, mask=None, pos_emb=None):
        q = self._split(self.linear_q(query))
        k = self._split(self.linear_k(key))
        v = self._split(self.linear_v(value))
        scores = torch.matmul(q, k.transpose(-1, -2)).float() * self.d_k ** -0.5
        return self.linear_out(_softmax_context(scores, v, mask,
                                                self.attn_dropout))


class RelPositionMultiHeadedAttention(MultiHeadedAttention):
    """scores = ((q+u)k^T + (q+v)p^T) / sqrt(d_k), p = linear_pos(pos_emb);
    pos_bias_u/v are float32 parameters cast to the compute dtype."""

    def __init__(self, num_heads: int, d_model: int,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0):
        super().__init__(num_heads, d_model, dtype, dropout_rate)
        self.linear_pos = Dense(d_model, d_model, bias=False, dtype=dtype)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, self.d_k))

    def forward(self, query, key, value, mask=None, pos_emb=None):
        if pos_emb is None:
            raise ValueError("rel-pos attention needs pos_emb")
        q = self.linear_q(query)
        b, t, _ = q.shape
        q = q.view(b, t, self.h, self.d_k)
        k = self._split(self.linear_k(key))
        v = self._split(self.linear_v(value))
        p = self._split(self.linear_pos(pos_emb.to(q.dtype)))  # [1|B,H,T,D]
        u = self.pos_bias_u.to(q.dtype)
        vb = self.pos_bias_v.to(q.dtype)
        q2 = torch.cat([q + u, q + vb], dim=-1).transpose(1, 2)
        k2 = torch.cat([k, p.expand_as(k)], dim=-1)
        scores = torch.matmul(q2, k2.transpose(-1, -2)).float() \
            * self.d_k ** -0.5
        return self.linear_out(_softmax_context(scores, v, mask,
                                                self.attn_dropout))
