"""Transformer decoders (PyTorch). Port of openeat_tpu/modules/decoder.py:
the full-sequence forward of TransformerDecoder (token embed -> absolute
PE -> N layers -> LayerNorm eps 1e-12 -> output linear or the tied
embedding) and BiTransformerDecoder (left-to-right plus an optional
right-to-left decoder), with dropout at the JAX sites, and the
incremental decode of the attention mode: init_cache projects the
cross-attention K/V once and allocates static self-attention caches,
forward_step scores one position against them."""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from openeat_torch.modules.decoder_layer import DecoderLayer
from openeat_torch.modules.embedding import PositionalEncoding
from openeat_torch.modules.layers import Dense, Embed, LayerNorm


class Decoder(nn.Module):
    """Layer stack `layer_{i}`, each applied num_blocks_share times."""

    def __init__(self, d_model: int, attention_heads: int, linear_units: int,
                 activation: Callable, num_blocks: int, num_blocks_share: int,
                 dtype: torch.dtype, dropout_rate: float = 0.0,
                 use_adapter: bool = False, down_size: int = 64,
                 scalar: float = 0.1):
        super().__init__()
        self.num_blocks_share = num_blocks_share
        self.num_layers = num_blocks // num_blocks_share
        for i in range(self.num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(
                d_model, attention_heads, linear_units, activation, dtype,
                dropout_rate, use_adapter=use_adapter, down_size=down_size,
                scalar=scalar))

    def applications(self) -> list[DecoderLayer]:
        """The layers in the order they are applied (sharing repeats)."""
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)
                for _ in range(self.num_blocks_share)]

    def forward(self, x, tgt_mask, memory, memory_mask):
        for layer in self.applications():
            x = layer(x, tgt_mask, memory, memory_mask)
        return x


class TransformerDecoder(nn.Module):
    def __init__(self, vocab_size: int, d_model: int, attention_heads: int,
                 linear_units: int, activation: Callable, num_blocks: int,
                 num_blocks_share: int = 1, share_embedding: bool = False,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0,
                 positional_dropout_rate: float = 0.0,
                 use_adapter: bool = False, down_size: int = 64,
                 scalar: float = 0.1):
        super().__init__()
        self.embed = Embed(vocab_size, d_model, dtype)
        self.pos_enc = PositionalEncoding(d_model, positional_dropout_rate)
        self.decoders = Decoder(d_model, attention_heads, linear_units,
                                activation, num_blocks, num_blocks_share,
                                dtype, dropout_rate, use_adapter, down_size,
                                scalar)
        self.after_norm = LayerNorm(d_model, 1e-12, dtype)
        self.share_embedding = share_embedding
        if not share_embedding:
            self.output_layer = Dense(d_model, vocab_size, dtype=dtype)

    def forward(self, tgt, tgt_mask, memory, memory_mask):
        """tgt: [B, L] tokens. Returns logits [B, L, V] float32."""
        x, _ = self.pos_enc(self.embed(tgt))
        x = self.after_norm(self.decoders(x, tgt_mask, memory, memory_mask))
        return self._head(x).float()

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return self.embed.attend(x) if self.share_embedding \
            else self.output_layer(x)

    # ---- incremental decode ----

    def init_cache(self, memory: torch.Tensor, batch: int,
                   max_len: int) -> dict:
        """Decode cache for `batch` rows and `max_len` positions: the
        cross-attention K/V of `memory` per layer application, and zeroed
        self-attention caches [batch, max_len, H, Dk] in the compute
        dtype."""
        apps = self.decoders.applications()
        attn = apps[0].self_attn
        shape = (batch, max_len, attn.h, attn.d_k)
        dtype = self.embed.compute_dtype
        return {"cross": [layer.init_cross_cache(memory) for layer in apps],
                "self_k": [memory.new_zeros(shape, dtype=dtype)
                           for _ in apps],
                "self_v": [memory.new_zeros(shape, dtype=dtype)
                           for _ in apps]}

    def forward_step(self, tokens: torch.Tensor, pos: int, cache: dict,
                     memory_mask: torch.Tensor
                     ) -> tuple[torch.Tensor, dict]:
        """Score one position: tokens [B] at `pos`. Returns (float32
        log-probs [B, V], the cache with this position written). The
        positional row is computed here as the JAX package does (float32
        exp(-i * (2/d) * log 1e4), sin/cos interleaved, cast to the
        compute dtype), not read from a table."""
        x = self.embed(tokens[:, None])                       # [B, 1, D]
        d = x.shape[-1]
        i = torch.arange(d // 2, dtype=torch.float32, device=x.device)
        ang = float(pos) * torch.exp(-i * (2.0 / d) * math.log(10000.0))
        pe_row = torch.stack([torch.sin(ang), torch.cos(ang)], -1).reshape(d)
        x = x * d ** 0.5 + pe_row.to(x.dtype)
        self_k, self_v = [], []
        for idx, layer in enumerate(self.decoders.applications()):
            x, sk, sv = layer.step(x, pos, cache["self_k"][idx],
                                   cache["self_v"][idx], cache["cross"][idx],
                                   memory_mask)
            self_k.append(sk)
            self_v.append(sv)
        logits = self._head(self.after_norm(x))[:, 0].float()
        return torch.log_softmax(logits, dim=-1), {
            "cross": cache["cross"], "self_k": self_k, "self_v": self_v}


class BiTransformerDecoder(nn.Module):
    def __init__(self, vocab_size: int, d_model: int, attention_heads: int,
                 linear_units: int, activation: Callable, num_blocks: int,
                 r_num_blocks: int = 0, num_blocks_share: int = 1,
                 share_embedding: bool = False,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0,
                 positional_dropout_rate: float = 0.0,
                 use_adapter: bool = False, down_size: int = 64,
                 scalar: float = 0.1):
        super().__init__()

        def make(n: int) -> TransformerDecoder:
            return TransformerDecoder(
                vocab_size, d_model, attention_heads, linear_units,
                activation, n, num_blocks_share, share_embedding, dtype,
                dropout_rate, positional_dropout_rate, use_adapter,
                down_size, scalar)

        self.left_decoder = make(num_blocks)
        if r_num_blocks > 0:
            self.right_decoder = make(r_num_blocks)

    def forward(self, memory, memory_mask, ys_in, r_ys_in, tgt_mask):
        """Training forward: (left logits, right logits) [B, L, V] float32;
        the right logits are zeros without a right decoder, as in the
        JAX module."""
        left = self.left_decoder(ys_in, tgt_mask, memory, memory_mask)
        if hasattr(self, "right_decoder"):
            right = self.right_decoder(r_ys_in, tgt_mask, memory,
                                       memory_mask)
        else:
            right = torch.zeros_like(left)
        return left, right

    def init_cache(self, memory, batch, max_len):
        return self.left_decoder.init_cache(memory, batch, max_len)

    def forward_step(self, tokens, pos, cache, memory_mask):
        return self.left_decoder.forward_step(tokens, pos, cache,
                                              memory_mask)
