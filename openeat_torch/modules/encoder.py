"""ASR encoder (PyTorch). Port of openeat_tpu/modules/encoder.py:
TransformerEncoder and its block stack, the streaming `forward_chunk`
of both included.

Optional GlobalCMVN -> the input layer's embed (`input_layer`: linear,
conv2d x4, conv2d6 or conv2d8 subsampling) -> N blocks -> final
LayerNorm (eps 1e-5). With num_blocks_share = s, num_blocks // s
physical layers `layer_{i}` are each applied s times in a row.

Chunk masks: `static_chunk_size` > 0 limits every query to its chunk
and `num_left_chunks` chunks before it (-1: all of them);
`use_dynamic_chunk` draws a chunk size per batch in training only, as
the JAX encoder does: u uniform in [1, max(T, 2)), then T if u > T // 2
(full context) else u % 25 + 1. The draw comes from `chunk_generator`,
which openeat_torch.modules.dropout.set_generator points at the
trainer's chunk generator: the dropout generator itself in one process,
and under data parallelism one generator that every data rank seeds
alike, so that the data group trains one chunk size a step, as the JAX
encoder draws one a global batch.

Sequence parallelism (`sequence_sharding`, the JAX encoder's
`seq_shard`): once openeat_torch/parallel/mesh.py's apply_mesh gives
the stack a `time_shard` (a model group of n > 1 ranks), the block
stack runs on rank i's frames [i*T/n, (i+1)*T/n) of the embed's output
and gathers time after after_norm. T' that n does not divide runs
unsharded, as in JAX, and so does a shard shorter than the conv
module's halo (K-1 frames causal, (K-1)/2 otherwise), which JAX would
shard: the numbers are the same either way. The replicated parameters
of the stack (those the TP rules leave whole, outside an MoE FFN) see
only their rank's frames, so one all-reduce sums their gradients over
the model group in the backward.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.func import functional_call

from openeat_torch.modules.cmvn import GlobalCMVN
from openeat_torch.modules.embedding import POS_ENC_CLASSES, sinusoid_table
from openeat_torch.modules.encoder_layer import EncoderLayer
from openeat_torch.modules.feed_forward import MoEPositionwiseFeedForward
from openeat_torch.modules.layers import LayerNorm
from openeat_torch.modules.subsampling import SUBSAMPLE_CLASSES
from openeat_torch.parallel import tensor_parallel as tp
from openeat_torch.utils.mask import (chunk_mask, dynamic_chunk_mask,
                                      make_non_pad_mask)


class Encoder(nn.Module):
    """Block stack with `after_norm`."""

    def __init__(self, d_model: int, attention_heads: int, linear_units: int,
                 activation: Callable, macaron_style: bool,
                 use_cnn_module: bool, cnn_module_kernel: int, causal: bool,
                 num_blocks: int, num_blocks_share: int, dtype: torch.dtype,
                 dropout_rate: float = 0.0, moe_experts: int = 0,
                 moe_top_k: int = 2, moe_capacity_factor: float = 1.25,
                 use_adapter: bool = False, down_size: int = 64,
                 scalar: float = 0.1):
        super().__init__()
        self.num_blocks_share = num_blocks_share
        self.num_layers = num_blocks // num_blocks_share
        self.time_shard: tp.TimeShard | None = None   # set by apply_mesh
        for i in range(self.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(
                d_model, attention_heads, linear_units, activation,
                macaron_style, use_cnn_module, cnn_module_kernel, causal,
                dtype, dropout_rate, moe_experts=moe_experts,
                moe_top_k=moe_top_k,
                moe_capacity_factor=moe_capacity_factor,
                use_adapter=use_adapter, down_size=down_size,
                scalar=scalar))
        self.after_norm = LayerNorm(d_model, 1e-5, dtype)

    def applications(self) -> list[EncoderLayer]:
        """The layers in the order they run, each shared layer repeated."""
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)
                for _ in range(self.num_blocks_share)]

    def forward(self, xs, mask, pos_emb, mask_pad=None, moe_aux=None):
        sp = self.shard_for(xs.shape[1])
        if sp is not None:
            return self._forward_sharded(xs, mask, pos_emb, mask_pad,
                                         moe_aux, sp)
        for layer in self.applications():
            xs = layer(xs, mask, pos_emb, mask_pad, moe_aux)
        return self.after_norm(xs)

    def shard_for(self, t: int) -> tp.TimeShard | None:
        """The time shard a stack input of t frames runs on, or None."""
        sp = self.time_shard
        if sp is None or t % sp.n:
            return None
        conv = getattr(self.layer_0, "conv_module", None)
        halo = 0 if conv is None else max(conv.padding)
        return sp if t // sp.n >= halo else None

    def _forward_sharded(self, xs, mask, pos_emb, mask_pad, moe_aux, sp):
        """The stack on this rank's frames; its output gathered whole."""
        moe = tuple(name + "." for name, m in self.named_modules()
                    if isinstance(m, MoEPositionwiseFeedForward))
        names = [n for n, p in self.named_parameters()
                 if p.requires_grad and not hasattr(p, "tp_dim")
                 and not n.startswith(moe)]
        used = dict(zip(names, tp.sum_grads(
            [self.get_parameter(n) for n in names], sp.group)))

        def call(module, prefix, *args, **kwargs):
            own = {n[len(prefix):]: p for n, p in used.items()
                   if n.startswith(prefix)}
            return functional_call(module, own, args, kwargs)

        xs = tp.split_time(xs, sp)
        for i in range(self.num_layers):
            for _ in range(self.num_blocks_share):
                xs = call(getattr(self, f"layer_{i}"), f"layer_{i}.", xs,
                          mask, pos_emb, mask_pad, moe_aux, sp=sp)
        xs = call(self.after_norm, "after_norm.", xs)
        return tp.gather_time(xs, sp, reduce_grad=False)

    def forward_chunk(self, xs, k_caches, v_caches, kv_mask, cnn_caches,
                      pos_emb):
        """Streaming step across the stack; the caches are sequences
        with one entry per application. Returns (out, new_k, new_v,
        new_cnn), the k/v entries being the chunk's own keys and values
        for the caller to roll into the histories."""
        new_k, new_v, new_cnn = [], [], []
        for idx, layer in enumerate(self.applications()):
            xs, k, v, c = layer.forward_chunk(
                xs, k_caches[idx], v_caches[idx], kv_mask, cnn_caches[idx],
                pos_emb)
            new_k.append(k)
            new_v.append(v)
            new_cnn.append(c)
        return self.after_norm(xs), new_k, new_v, new_cnn


class TransformerEncoder(nn.Module):
    def __init__(self, input_size: int, d_model: int, attention_heads: int,
                 linear_units: int, activation: Callable,
                 input_layer: str = "conv2d",
                 pos_enc_layer_type: str = "rel_pos",
                 macaron_style: bool = True, use_cnn_module: bool = True,
                 cnn_module_kernel: int = 15, causal: bool = False,
                 num_blocks: int = 12, num_blocks_share: int = 1,
                 use_global_cmvn: bool = False,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0,
                 positional_dropout_rate: float = 0.0,
                 static_chunk_size: int = 0, num_left_chunks: int = -1,
                 use_dynamic_chunk: bool = False, moe_experts: int = 0,
                 moe_top_k: int = 2, moe_capacity_factor: float = 1.25,
                 use_adapter: bool = False, down_size: int = 64,
                 scalar: float = 0.1):
        super().__init__()
        self.dtype = dtype
        self.d_model = d_model
        self.static_chunk_size = static_chunk_size
        self.num_left_chunks = num_left_chunks
        self.use_dynamic_chunk = use_dynamic_chunk
        # the dynamic chunk draw's generator (set_generator sets it)
        self.chunk_generator: torch.Generator | None = None
        if use_global_cmvn:
            self.global_cmvn = GlobalCMVN(input_size)
        self.use_global_cmvn = use_global_cmvn
        pos_enc = POS_ENC_CLASSES[pos_enc_layer_type](
            d_model, positional_dropout_rate)
        extra = {"dropout_rate": dropout_rate} if input_layer == "linear" \
            else {}
        self.embed = SUBSAMPLE_CLASSES[input_layer](input_size, d_model,
                                                    pos_enc, dtype, **extra)
        self.encoders = Encoder(
            d_model, attention_heads, linear_units, activation,
            macaron_style, use_cnn_module, cnn_module_kernel, causal,
            num_blocks, num_blocks_share, dtype, dropout_rate, moe_experts,
            moe_top_k, moe_capacity_factor, use_adapter, down_size, scalar)

    def _chunk_mask(self, t: int, device: torch.device,
                    chunk_size: int | None) -> torch.Tensor | None:
        """[T, T] attention mask of the chunk settings, or None (full
        context). `chunk_size` replaces the dynamic draw."""
        if self.use_dynamic_chunk and self.training:
            if chunk_size is None:
                if self.chunk_generator is None:
                    raise RuntimeError(
                        "dynamic-chunk training needs a generator; call "
                        "openeat_torch.modules.dropout.set_generator")
                g = self.chunk_generator
                u = torch.randint(1, max(t, 2), (), generator=g,
                                  device=g.device)
                chunk_size = torch.where(u > t // 2, t, u % 25 + 1)
            return dynamic_chunk_mask(t, torch.as_tensor(chunk_size,
                                                         device=device),
                                      self.num_left_chunks)
        if chunk_size is not None:
            raise ValueError("chunk_size replaces the dynamic chunk draw, "
                             "which only training with use_dynamic_chunk "
                             "makes")
        if self.static_chunk_size > 0:
            return chunk_mask(t, self.static_chunk_size,
                              self.num_left_chunks, device)
        return None

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor,
                chunk_size: int | torch.Tensor | None = None,
                moe_aux: list | None = None):
        """xs: [B, T, F] features; xs_lens: [B]; chunk_size: the dynamic
        chunk size to use in place of the training draw; moe_aux: a list
        that each MoE layer application appends its aux loss to.
        Returns (encoder_out [B, T', D], out_lens [B], pos_emb [1, T', D])."""
        if self.use_global_cmvn:
            xs = self.global_cmvn(xs)
        xs, pos_emb, out_lens = self.embed(xs.to(self.dtype), xs_lens)
        mask_pad = make_non_pad_mask(out_lens, xs.shape[1])[:, None, :]
        mask = mask_pad
        cm = self._chunk_mask(xs.shape[1], xs.device, chunk_size)
        if cm is not None:
            mask = mask & cm[None]
        xs = self.encoders(xs, mask, pos_emb, mask_pad, moe_aux)
        return xs, out_lens, pos_emb

    def forward_chunk(self, feat_window: torch.Tensor,
                      offset: int | torch.Tensor, k_caches, v_caches,
                      cache_len: int | torch.Tensor, cnn_caches,
                      valid_len: int | torch.Tensor | None = None):
        """Streaming step on a raw feature window.

        feat_window: [B, W, F] with W = 4c + 3 frames for c outputs of
        the conv2d x4 subsampling; offset: the absolute output position
        of the chunk's first frame; k_caches, v_caches: one [B, Lc, H,
        Dk] right-aligned history per application, of which the last
        cache_len slots are valid; cnn_caches: [B, K-1, D] each;
        valid_len: the chunk's valid outputs (the final, zero-padded
        chunk of a stream has fewer than c; None: all). offset,
        cache_len and valid_len are ints, or tensors [B] with one value
        per stream. Returns (chunk_out [B, c, D], new_k, new_v,
        new_cnn)."""
        if self.use_global_cmvn:
            feat_window = self.global_cmvn(feat_window)
        feat_window = feat_window.to(self.dtype)
        b, w, _ = feat_window.shape
        dev = feat_window.device
        lens = torch.full((b,), w, dtype=torch.long, device=dev)
        xs, _, _ = self.embed(feat_window, lens, offset)
        t_chunk = xs.shape[1]
        l_cache = k_caches[0].shape[1]

        def per_row(v):
            return v.view(-1, 1, 1) if isinstance(v, torch.Tensor) else v

        if valid_len is None:
            valid_len = t_chunk
        slot = torch.arange(l_cache + t_chunk, device=dev)[None, None, :]
        in_cache = (slot >= l_cache - per_row(cache_len)) & (slot < l_cache)
        in_chunk = (slot >= l_cache) & (slot - l_cache < per_row(valid_len))
        kv_mask = (in_cache | in_chunk).expand(b, 1, l_cache + t_chunk)
        # slot i of the kv window holds absolute position
        # offset - (l_cache - i): the offline forward's convention of a
        # position row per key (no rel_shift)
        pe = sinusoid_table(l_cache + t_chunk, self.d_model, xs.dtype, dev,
                            offset - l_cache)
        pos_emb = pe if pe.dim() == 3 else pe[None]
        return self.encoders.forward_chunk(xs, k_caches, v_caches, kv_mask,
                                           cnn_caches, pos_emb)
