"""Multi-head attention: vanilla and Transformer-XL relative-position
(PyTorch). Port of openeat_tpu/modules/attention.py.

Scores are taken in float32, masked positions are filled with -1e9
before the softmax and zeroed after it (a fully masked query row gives
0, not NaN), dropout (rate 0 unless set, as in the JAX modules) acts on
the probabilities, and the rel-pos variant computes (q+u)k^T + (q+v)p^T as one
product over the concatenated 2*d_k contraction, without rel_shift (the
WeNet convention the JAX package keeps). Its `forward_chunk` is the
streaming step: the chunk's queries attend over a right-aligned K/V
history and the chunk's own keys and values. These are plain matmuls:
no Pallas kernel stands behind them in the JAX package.

Under sequence parallelism (`sp`, a TimeShard of
openeat_torch/parallel/tensor_parallel.py) self-attention takes its
rank's frames [B, T/n, D] and gives its rank's outputs. With the heads
sharded over the model group (mesh.py's TP rules) it gathers time once,
runs its heads over all T queries and reduce-scatters after the
row-parallel linear_out, as Megatron-LM's sequence parallelism does.
With the heads replicated it runs its own queries against the gathered
keys and values; a [B, T, T] mask then gives the queries' rows. The
rel-pos term takes the whole pos_emb either way (one row per key).
"""

from __future__ import annotations

import torch
from torch import nn

from openeat_torch.modules.dropout import Dropout
from openeat_torch.modules.layers import Dense
from openeat_torch.parallel import tensor_parallel as tp
from openeat_torch.utils.mask import NEG_INF
from openeat_torch.utils.weight_mirror import at_compute


def _softmax_context(scores: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor | None,
                     dropout: Dropout | None, shard=None) -> torch.Tensor:
    """scores [B, H, Tq, Tk] f32 (already scaled); v [B, H, Tk, D];
    mask bool [B, 1, Tk] or [B, Tq, Tk], True = attend; dropout None
    for none, `shard` its per-call shard. Returns ctx [B, Tq, H*D] in
    v's dtype."""
    if mask is not None:
        m = mask[:, None]
        scores = scores.masked_fill(~m, NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    if mask is not None:
        attn = attn.masked_fill(~m, 0.0)
    attn = attn.to(v.dtype)
    if dropout is not None:
        attn = dropout(attn, shard)
    ctx = torch.matmul(attn, v)
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

    def forward(self, query, key, value, mask=None, pos_emb=None,
                sp: tp.TimeShard | None = None):
        """sp: self-attention on this rank's time shard (query, key and
        value are one tensor [B, T/n, D])."""
        if sp is not None:
            return self._forward_sharded(query, mask, pos_emb, sp)
        k = self._split(self.linear_k(key))
        v = self._split(self.linear_v(value))
        return self.linear_out(_softmax_context(
            self._scores(query, k, pos_emb), v, mask, self.attn_dropout))

    def _scores(self, query: torch.Tensor, k: torch.Tensor, pos_emb,
                proj=Dense.__call__) -> torch.Tensor:
        """Scaled float32 scores [B, H, Tq, Tk] of query [B, Tq, D]
        against k [B, H, Tk, Dk]; `proj` applies a Dense."""
        q = self._split(proj(self.linear_q, query))
        return torch.matmul(q, k.transpose(-1, -2)).float() \
            * self.d_k ** -0.5

    def _forward_sharded(self, h: torch.Tensor, mask, pos_emb,
                         sp: tp.TimeShard) -> torch.Tensor:
        whole = tp.gather_time(h, sp)
        k = self._split(self.linear_k.local(whole))
        v = self._split(self.linear_v.local(whole))
        if self.linear_out.tp_mode is not None:     # heads sharded
            ctx = _softmax_context(
                self._scores(whole, k, pos_emb, Dense.local), v, mask,
                self.attn_dropout)
            y = tp.scatter_time(self.linear_out.local(ctx), sp)
            return y + self.linear_out.bias.to(y.dtype)
        if mask is not None and mask.shape[1] > 1:
            mask = sp.local(mask)
        ctx = _softmax_context(self._scores(h, k, pos_emb, Dense.local), v,
                               mask, self.attn_dropout, (2, sp.n, sp.i))
        return self.linear_out(ctx)

    # ---- incremental decode (KV caching); layouts [B, L, H, Dk] ----

    def project_q(self, query: torch.Tensor) -> torch.Tensor:
        """[B, L, D] -> [B, L, H, Dk]."""
        q = self.linear_q(query)
        return q.view(q.shape[0], q.shape[1], self.h, self.d_k)

    def project_kv(self, x: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """[B, L, D] -> (k, v), each [B, L, H, Dk]."""
        b, t, _ = x.shape
        return (self.linear_k(x).view(b, t, self.h, self.d_k),
                self.linear_v(x).view(b, t, self.h, self.d_k))

    def attend_cached(self, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, mask: torch.Tensor | None = None
                      ) -> torch.Tensor:
        """Attention of q [B, Lq, H, Dk] over precomputed k, v [B, Lk, H,
        Dk]; mask bool [B, 1, Lk] or [B, Lq, Lk]. No dropout: decode
        only."""
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        scores = torch.matmul(q, k.transpose(-1, -2)).float() \
            * self.d_k ** -0.5
        return self.linear_out(_softmax_context(scores, v, mask, None))


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

    def forward(self, query, key, value, mask=None, pos_emb=None,
                sp: tp.TimeShard | None = None):
        if pos_emb is None:
            raise ValueError("rel-pos attention needs pos_emb")
        return super().forward(query, key, value, mask, pos_emb, sp)

    def _scores(self, query: torch.Tensor, k: torch.Tensor,
                pos_emb: torch.Tensor, proj=Dense.__call__) -> torch.Tensor:
        """Scaled float32 scores [B, H, Tq, Tk] of query [B, Tq, D]
        against k [B, H, Tk, Dk] and pos_emb [1|B, Tk, D]."""
        q = proj(self.linear_q, query)
        b, t, _ = q.shape
        q = q.view(b, t, self.h, self.d_k)
        p = self._split(proj(self.linear_pos, pos_emb.to(q.dtype)))
        u = at_compute(self.pos_bias_u, q.dtype)
        vb = at_compute(self.pos_bias_v, q.dtype)
        q2 = torch.cat([q + u, q + vb], dim=-1).transpose(1, 2)
        k2 = torch.cat([k, p.expand_as(k)], dim=-1)
        return torch.matmul(q2, k2.transpose(-1, -2)).float() \
            * self.d_k ** -0.5

    def forward_chunk(self, x: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, kv_mask: torch.Tensor,
                      pos_emb: torch.Tensor):
        """Streaming chunk attention. x: [B, Tc, D]; k_cache, v_cache:
        [B, Lc, H, Dk] right-aligned histories; kv_mask: bool [B, 1,
        Lc+Tc], True = a valid slot; pos_emb: [1|B, Lc+Tc, D], the
        absolute-position rows of the kv window (a masked slot's row may
        be anything finite). Returns (out [B, Tc, D], k_new, v_new
        [B, Tc, H, Dk]); the caller rolls k_new, v_new into the
        histories."""
        k_new, v_new = self.project_kv(x)
        k = torch.cat([k_cache.to(k_new.dtype), k_new], dim=1).transpose(1, 2)
        v = torch.cat([v_cache.to(v_new.dtype), v_new], dim=1).transpose(1, 2)
        ctx = _softmax_context(self._scores(x, k, pos_emb), v, kv_mask, None)
        return self.linear_out(ctx), k_new, v_new
