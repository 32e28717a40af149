"""Conformer/Transformer encoder block (PyTorch).
Port of openeat_tpu/modules/encoder_layer.py:EncoderLayer, its
streaming `forward_chunk` included.

Pre-norm: half-scaled macaron FFN -> MHA -> convolution module -> FFN
-> final LayerNorm when a conv module is present; LayerNorm eps 1e-12.
Each branch's output passes dropout at dropout_rate before the residual
add; attention probabilities drop at attention_dropout_rate (0.0 in the
JAX modules). `forward_chunk` runs the same order on one chunk, with
the attention's K/V history and the conv cache, and no dropout.

With moe_experts > 0 the main FFN is MoEPositionwiseFeedForward (the
macaron FFN stays dense): `forward` routes with the padding mask and
appends the layer's aux loss to `moe_aux` when given one;
`forward_chunk` routes each row's chunk on its own with no pad mask, so
a chunk has its own capacity, as the JAX layer's streaming step has.

With use_adapter the fine-tuning Adapter (modules/feed_forward.py) runs
in parallel to the main FFN, on the block's input to it, and only its
scaled bottleneck update is added beside the FFN's residual, in
`forward` and in `forward_chunk`.

Under sequence parallelism (`sp`) x is this rank's frames [B, T/n, D]:
the norms, residuals, dropouts (each drawing the whole mask and keeping
the rank's frames) and the conv module run on them, attention and the
FFNs place their own collectives, and an MoE FFN gathers the whole time
(its capacity and buffer positions count every token in order), runs
as without sharding and keeps the rank's frames.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from openeat_torch.modules.attention import (MultiHeadedAttention,
                                             RelPositionMultiHeadedAttention)
from openeat_torch.modules.convolution import ConvolutionModule
from openeat_torch.modules.dropout import Dropout
from openeat_torch.modules.feed_forward import (Adapter,
                                                MoEPositionwiseFeedForward,
                                                PositionwiseFeedForward)
from openeat_torch.modules.layers import LayerNorm
from openeat_torch.parallel import tensor_parallel as tp


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, attention_heads: int, linear_units: int,
                 activation: Callable, macaron_style: bool = True,
                 use_cnn_module: bool = True, cnn_module_kernel: int = 15,
                 causal: bool = False, dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0,
                 attention_dropout_rate: float = 0.0, moe_experts: int = 0,
                 moe_top_k: int = 2, moe_capacity_factor: float = 1.25,
                 use_adapter: bool = False, down_size: int = 64,
                 scalar: float = 0.1):
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
        if use_adapter:
            self.adapter = Adapter(d_model, dropout_rate, down_size, scalar,
                                   dtype)
        self.use_adapter = use_adapter
        self.norm_ff = ln()
        self.moe = moe_experts > 0
        if self.moe:
            self.feed_forward = MoEPositionwiseFeedForward(
                d_model, linear_units, moe_experts, moe_top_k,
                moe_capacity_factor, activation, dtype, dropout_rate)
        else:
            self.feed_forward = ffn()
        self.drop = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                pos_emb: torch.Tensor,
                mask_pad: torch.Tensor | None = None,
                moe_aux: list | None = None,
                sp: tp.TimeShard | None = None) -> torch.Tensor:
        """x: [B, T, D]; mask: bool [B, 1, T] attention mask (True =
        attend); mask_pad: bool [B, 1, T] for the conv module and the
        MoE router (defaults to mask); pos_emb: [1, T, D]; moe_aux: a
        list that an MoE layer appends its aux loss to; sp: x is this
        rank's time shard [B, T/n, D] (the masks and pos_emb stay
        whole)."""
        if mask_pad is None:
            mask_pad = mask
        shard = None if sp is None else (1, sp.n, sp.i)
        if self.macaron_style:
            x = x + self.ff_scale * self.drop(self.feed_forward_macaron(
                self.norm_ff_macaron(x), sp), shard)
        h = self.norm_mha(x)
        x = x + self.drop(self.self_attn(h, h, h, mask, pos_emb, sp=sp),
                          shard)
        if self.use_cnn_module:
            pad = mask_pad if sp is None else sp.local(mask_pad, -1)
            x = x + self.drop(self.conv_module(self.norm_conv(x), pad,
                                               sp=sp), shard)
        adapter_update = self.adapter(x, shard) if self.use_adapter else 0.0
        if self.moe:
            h = self.norm_ff(x)
            if sp is not None:
                h = tp.gather_time(h, sp, reduce_grad=False)
            h, aux = self.feed_forward(h, mask_pad)
            if sp is not None:
                h = tp.split_time(h, sp)
            if moe_aux is not None:
                moe_aux.append(aux)
        else:
            h = self.feed_forward(self.norm_ff(x), sp)
        x = x + self.ff_scale * self.drop(h, shard) + adapter_update
        if self.use_cnn_module:
            x = self.norm_final(x)
        return x

    def forward_chunk(self, x: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, kv_mask: torch.Tensor,
                      cnn_cache: torch.Tensor, pos_emb: torch.Tensor):
        """Streaming step of a Conformer block. x: [B, Tc, D]; k_cache,
        v_cache: [B, Lc, H, Dk] right-aligned histories; kv_mask: bool
        [B, 1, Lc+Tc]; cnn_cache: [B, K-1, D]; pos_emb: [1|B, Lc+Tc, D].
        Returns (y, k_new, v_new, new_cnn_cache)."""
        if not self.use_cnn_module:
            raise ValueError("streaming needs Conformer blocks")
        if self.macaron_style:
            x = x + self.ff_scale * self.feed_forward_macaron(
                self.norm_ff_macaron(x))
        h, k_new, v_new = self.self_attn.forward_chunk(
            self.norm_mha(x), k_cache, v_cache, kv_mask, pos_emb)
        x = x + h
        h, new_cnn = self.conv_module(self.norm_conv(x), None, cnn_cache)
        x = x + h
        adapter_update = self.adapter(x) if self.use_adapter else 0.0
        h = self.norm_ff(x)
        if self.moe:
            # each row is a stream: it routes its chunk alone, with the
            # chunk's capacity, as the JAX runtimes' single-stream step
            # (vmapped over the slots) does
            h = torch.cat([self.feed_forward(row[None])[0] for row in h])
        else:
            h = self.feed_forward(h)
        x = x + self.ff_scale * h + adapter_update
        return self.norm_final(x), k_new, v_new, new_cnn
