"""Conformer/Transformer encoder block (PyTorch).
Port of openeat_tpu/modules/encoder_layer.py:EncoderLayer.__call__.

Pre-norm: half-scaled macaron FFN -> MHA -> convolution module -> FFN
-> final LayerNorm when a conv module is present; LayerNorm eps 1e-12.
Each branch's output passes dropout at dropout_rate before the residual
add; attention probabilities drop at attention_dropout_rate (0.0 in the
JAX modules).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from openeat_torch.modules.attention import (MultiHeadedAttention,
                                             RelPositionMultiHeadedAttention)
from openeat_torch.modules.convolution import ConvolutionModule
from openeat_torch.modules.dropout import Dropout
from openeat_torch.modules.feed_forward import PositionwiseFeedForward
from openeat_torch.modules.layers import LayerNorm


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, attention_heads: int, linear_units: int,
                 activation: Callable, macaron_style: bool = True,
                 use_cnn_module: bool = True, cnn_module_kernel: int = 15,
                 causal: bool = False, dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0,
                 attention_dropout_rate: float = 0.0):
        super().__init__()
        ln = lambda: LayerNorm(d_model, 1e-12, dtype)  # noqa: E731
        ffn = lambda: PositionwiseFeedForward(  # noqa: E731
            d_model, linear_units, activation, dtype, dropout_rate)
        self.macaron_style = macaron_style
        self.use_cnn_module = use_cnn_module
        self.ff_scale = 0.5 if macaron_style else 1.0
        if macaron_style:
            self.norm_ff_macaron = ln()
            self.feed_forward_macaron = ffn()
        self.norm_mha = ln()
        attn_cls = (RelPositionMultiHeadedAttention if use_cnn_module
                    else MultiHeadedAttention)
        self.self_attn = attn_cls(attention_heads, d_model, dtype,
                                  attention_dropout_rate)
        if use_cnn_module:
            self.norm_conv = ln()
            self.conv_module = ConvolutionModule(
                d_model, cnn_module_kernel, activation, causal, dtype)
            self.norm_final = ln()
        self.norm_ff = ln()
        self.feed_forward = ffn()
        self.drop = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                pos_emb: torch.Tensor,
                mask_pad: torch.Tensor | None = None) -> torch.Tensor:
        """x: [B, T, D]; mask: bool [B, 1, T] attention mask (True =
        attend); mask_pad: bool [B, 1, T] for the conv module (defaults
        to mask); pos_emb: [1, T, D]."""
        if mask_pad is None:
            mask_pad = mask
        if self.macaron_style:
            x = x + self.ff_scale * self.drop(self.feed_forward_macaron(
                self.norm_ff_macaron(x)))
        h = self.norm_mha(x)
        x = x + self.drop(self.self_attn(h, h, h, mask, pos_emb))
        if self.use_cnn_module:
            x = x + self.drop(self.conv_module(self.norm_conv(x), mask_pad))
        x = x + self.ff_scale * self.drop(self.feed_forward(self.norm_ff(x)))
        if self.use_cnn_module:
            x = self.norm_final(x)
        return x
