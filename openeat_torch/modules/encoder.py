"""ASR encoder (PyTorch). Port of openeat_tpu/modules/encoder.py:
TransformerEncoder.__call__ and its block stack.

Optional GlobalCMVN -> conv2d x4 subsampling embed -> N blocks -> final
LayerNorm (eps 1e-5). With num_blocks_share = s, num_blocks // s
physical layers `layer_{i}` are each applied s times in a row.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from openeat_torch.modules.cmvn import GlobalCMVN
from openeat_torch.modules.embedding import POS_ENC_CLASSES
from openeat_torch.modules.encoder_layer import EncoderLayer
from openeat_torch.modules.layers import LayerNorm
from openeat_torch.modules.subsampling import Conv2dSubsampling4
from openeat_torch.utils.mask import make_non_pad_mask


class Encoder(nn.Module):
    """Block stack with `after_norm`."""

    def __init__(self, d_model: int, attention_heads: int, linear_units: int,
                 activation: Callable, macaron_style: bool,
                 use_cnn_module: bool, cnn_module_kernel: int, causal: bool,
                 num_blocks: int, num_blocks_share: int, dtype: torch.dtype,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.num_blocks_share = num_blocks_share
        self.num_layers = num_blocks // num_blocks_share
        for i in range(self.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(
                d_model, attention_heads, linear_units, activation,
                macaron_style, use_cnn_module, cnn_module_kernel, causal,
                dtype, dropout_rate))
        self.after_norm = LayerNorm(d_model, 1e-5, dtype)

    def forward(self, xs, mask, pos_emb, mask_pad=None):
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            for _ in range(self.num_blocks_share):
                xs = layer(xs, mask, pos_emb, mask_pad)
        return self.after_norm(xs)


class TransformerEncoder(nn.Module):
    def __init__(self, input_size: int, d_model: int, attention_heads: int,
                 linear_units: int, activation: Callable,
                 pos_enc_layer_type: str = "rel_pos",
                 macaron_style: bool = True, use_cnn_module: bool = True,
                 cnn_module_kernel: int = 15, causal: bool = False,
                 num_blocks: int = 12, num_blocks_share: int = 1,
                 use_global_cmvn: bool = False,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0,
                 positional_dropout_rate: float = 0.0):
        super().__init__()
        self.dtype = dtype
        if use_global_cmvn:
            self.global_cmvn = GlobalCMVN(input_size)
        self.use_global_cmvn = use_global_cmvn
        self.embed = Conv2dSubsampling4(
            input_size, d_model,
            POS_ENC_CLASSES[pos_enc_layer_type](d_model,
                                                positional_dropout_rate),
            dtype)
        self.encoders = Encoder(
            d_model, attention_heads, linear_units, activation,
            macaron_style, use_cnn_module, cnn_module_kernel, causal,
            num_blocks, num_blocks_share, dtype, dropout_rate)

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor):
        """xs: [B, T, F] features; xs_lens: [B].
        Returns (encoder_out [B, T', D], out_lens [B], pos_emb [1, T', D])."""
        if self.use_global_cmvn:
            xs = self.global_cmvn(xs)
        xs, pos_emb, out_lens = self.embed(xs.to(self.dtype), xs_lens)
        mask = make_non_pad_mask(out_lens, xs.shape[1])[:, None, :]
        xs = self.encoders(xs, mask, pos_emb, mask)
        return xs, out_lens, pos_emb
