"""Transformer decoders (PyTorch). Port of openeat_tpu/modules/decoder.py:
the full-sequence forward of TransformerDecoder (token embed -> absolute
PE -> N layers -> LayerNorm eps 1e-12 -> output linear or the tied
embedding) and BiTransformerDecoder (left-to-right plus an optional
right-to-left decoder), with dropout at the JAX sites. The KV-cache
forward_step comes with the attention decode mode."""

from __future__ import annotations

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
                 dtype: torch.dtype, dropout_rate: float = 0.0):
        super().__init__()
        self.num_blocks_share = num_blocks_share
        self.num_layers = num_blocks // num_blocks_share
        for i in range(self.num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(
                d_model, attention_heads, linear_units, activation, dtype,
                dropout_rate))

    def forward(self, x, tgt_mask, memory, memory_mask):
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            for _ in range(self.num_blocks_share):
                x = layer(x, tgt_mask, memory, memory_mask)
        return x


class TransformerDecoder(nn.Module):
    def __init__(self, vocab_size: int, d_model: int, attention_heads: int,
                 linear_units: int, activation: Callable, num_blocks: int,
                 num_blocks_share: int = 1, share_embedding: bool = False,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0,
                 positional_dropout_rate: float = 0.0):
        super().__init__()
        self.embed = Embed(vocab_size, d_model, dtype)
        self.pos_enc = PositionalEncoding(d_model, positional_dropout_rate)
        self.decoders = Decoder(d_model, attention_heads, linear_units,
                                activation, num_blocks, num_blocks_share,
                                dtype, dropout_rate)
        self.after_norm = LayerNorm(d_model, 1e-12, dtype)
        self.share_embedding = share_embedding
        if not share_embedding:
            self.output_layer = Dense(d_model, vocab_size, dtype=dtype)

    def forward(self, tgt, tgt_mask, memory, memory_mask):
        """tgt: [B, L] tokens. Returns logits [B, L, V] float32."""
        x, _ = self.pos_enc(self.embed(tgt))
        x = self.after_norm(self.decoders(x, tgt_mask, memory, memory_mask))
        head = self.embed.attend if self.share_embedding \
            else self.output_layer
        return head(x).float()


class BiTransformerDecoder(nn.Module):
    def __init__(self, vocab_size: int, d_model: int, attention_heads: int,
                 linear_units: int, activation: Callable, num_blocks: int,
                 r_num_blocks: int = 0, num_blocks_share: int = 1,
                 share_embedding: bool = False,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0,
                 positional_dropout_rate: float = 0.0):
        super().__init__()

        def make(n: int) -> TransformerDecoder:
            return TransformerDecoder(
                vocab_size, d_model, attention_heads, linear_units,
                activation, n, num_blocks_share, share_embedding, dtype,
                dropout_rate, positional_dropout_rate)

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
