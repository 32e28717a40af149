"""Hybrid CTC/attention ASR model (PyTorch).
Port of openeat_tpu/models/asr_model.py: build_asr_model, the training
forward with its joint loss (ctc_weight * CTC + (1 - ctc_weight) *
label-smoothed attention loss, the right-to-left decoder at
reverse_weight), and the decode methods encode, the streaming step
encode_chunk, ctc_log_probs, decoder_logits and the KV-cache pair
decoder_init_cache / decoder_step; sos = eos = vocab_size - 1. The
encoder's chunk masks (static_chunk_size, num_left_chunks,
use_dynamic_chunk) are those of the JAX model.

With moe_experts > 0 every encoder block's main FFN is a mixture of
experts (modules/feed_forward.py); the training forward returns the
mean of the layers' aux losses as `moe_aux`, which the train step adds
to the loss at moe_aux_weight (the eval loss leaves it out, as the JAX
eval step does). encoder_use_adapter / decoder_use_adapter put the
fine-tuning Adapter (down_size, scalar) in every encoder / decoder
block; openeat_torch/utils/optim.py trains them alone with
only_adapter.

Under a mesh's data group (`data_group`, set by openeat_torch/parallel/
mesh.py) every metric the forward returns is this rank's share of the
global batch's value (openeat_torch/parallel/tensor_parallel.py).
`sequence_sharding` shards the encoder block stack's time axis over the
mesh's model group (modules/encoder.py); `pipeline_head` and
`pipeline_tail` are the split points of the pipeline-parallel loss
(openeat_torch/parallel/pipeline.py).

`compute_dtype` sets the activations' dtype; parameters stay float32 and
are cast at use, as flax does, so bfloat16 compute trains float32
parameters. Dropout acts only in ``model.train()`` and only in the
training forward: the decode methods are deterministic in either mode,
as the JAX package's are (deterministic=True).
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn

from openeat_torch.modules.attention import RelPositionMultiHeadedAttention
from openeat_torch.modules.convolution import DepthwiseConv1d
from openeat_torch.modules.ctc import CTCHead
from openeat_torch.modules.decoder import BiTransformerDecoder
from openeat_torch.modules.encoder import TransformerEncoder
from openeat_torch.modules.feed_forward import (Adapter,
                                                MoEPositionwiseFeedForward)
from openeat_torch.modules.label_smoothing import label_smoothing_loss
from openeat_torch.modules.layers import Conv2d, Dense, Embed
from openeat_torch.parallel.tensor_parallel import share
from openeat_torch.utils.common import (IGNORE_ID, add_sos_eos,
                                        get_activation, reverse_pad_list,
                                        th_accuracy)
from openeat_torch.utils.mask import make_attn_mask, make_non_pad_mask

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

def deterministic(method):
    """Run a decode method with every submodule in eval mode."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        if not self.training:
            return method(self, *args, **kwargs)
        self.train(False)
        try:
            return method(self, *args, **kwargs)
        finally:
            self.train(True)
    return run


class ASRModel(nn.Module):
    def __init__(self, input_size: int = 80, vocab_size: int = 4233,
                 encoder_num_blocks: int = 12,
                 encoder_num_blocks_share: int = 1,
                 decoder_num_blocks: int = 3, r_decoder_num_blocks: int = 0,
                 decoder_num_blocks_share: int = 1,
                 input_layer: str = "conv2d",
                 pos_enc_layer_type: str = "rel_pos", d_model: int = 256,
                 attention_heads: int = 4, linear_units: int = 1024,
                 activation_type: str = "swish", macaron_style: bool = True,
                 use_cnn_module: bool = True, cnn_module_kernel: int = 15,
                 causal: bool = False, use_global_cmvn: bool = False,
                 tie_word_embedding: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.0,
                 ctc_weight: float = 0.3, lsm_weight: float = 0.1,
                 reverse_weight: float = 0.0,
                 length_normalized_loss: bool = False,
                 ctc_impl: str = "optax",
                 static_chunk_size: int = 0, num_left_chunks: int = -1,
                 use_dynamic_chunk: bool = False, moe_experts: int = 0,
                 moe_top_k: int = 2, moe_capacity_factor: float = 1.25,
                 moe_aux_weight: float = 0.01,
                 sequence_sharding: bool = False,
                 encoder_use_adapter: bool = False,
                 decoder_use_adapter: bool = False, down_size: int = 64,
                 scalar: float = 0.1):
        super().__init__()
        act = get_activation(activation_type)
        self.input_size = input_size
        self.input_layer = input_layer
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.attention_heads = attention_heads
        self.encoder_num_blocks = encoder_num_blocks
        self.cnn_module_kernel = cnn_module_kernel
        self.causal = causal
        self.compute_dtype = compute_dtype
        self.ctc_weight = ctc_weight
        self.lsm_weight = lsm_weight
        self.reverse_weight = reverse_weight
        self.length_normalized_loss = length_normalized_loss
        self.moe_experts = moe_experts
        self.moe_aux_weight = moe_aux_weight
        self.sequence_sharding = sequence_sharding
        self.data_group = None
        # the step's dropout generator (set_generator sets it)
        self.generator: torch.Generator | None = None
        self.encoder = TransformerEncoder(
            input_size, d_model, attention_heads, linear_units, act,
            input_layer, pos_enc_layer_type, macaron_style, use_cnn_module,
            cnn_module_kernel, causal, encoder_num_blocks,
            encoder_num_blocks_share, use_global_cmvn, compute_dtype,
            dropout_rate, positional_dropout_rate, static_chunk_size,
            num_left_chunks, use_dynamic_chunk, moe_experts, moe_top_k,
            moe_capacity_factor, encoder_use_adapter, down_size, scalar)
        self.ctc = CTCHead(d_model, vocab_size, compute_dtype,
                           length_normalized_loss, impl=ctc_impl)
        self.decoder = BiTransformerDecoder(
            vocab_size, d_model, attention_heads, linear_units, act,
            decoder_num_blocks, r_decoder_num_blocks,
            decoder_num_blocks_share, tie_word_embedding, compute_dtype,
            dropout_rate, positional_dropout_rate, decoder_use_adapter,
            down_size, scalar)

    @property
    def sos(self) -> int:
        return self.vocab_size - 1

    @property
    def eos(self) -> int:
        return self.vocab_size - 1

    # ---- training ----

    def forward(self, features: torch.Tensor, features_length: torch.Tensor,
                targets: torch.Tensor, targets_length: torch.Tensor,
                chunk_size: int | torch.Tensor | None = None
                ) -> dict[str, torch.Tensor]:
        """Joint loss. Returns the metrics dict: loss, loss_ctc, and
        loss_att and acc when ctc_weight < 1 (acc 0 otherwise), and
        moe_aux with mixture-of-experts layers. `chunk_size` replaces the
        dynamic chunk draw of a use_dynamic_chunk model in training."""
        aux = [] if self.moe_experts else None
        encoder_out, out_lens, _ = self.encoder(features, features_length,
                                                chunk_size, aux)
        metrics = self._joint_loss(encoder_out, out_lens, targets,
                                   targets_length)
        if aux:
            moe_aux = torch.stack(aux).sum() / len(aux)
            metrics["moe_aux"] = share(moe_aux, self.data_group)
        return metrics

    def _joint_loss(self, encoder_out, out_lens, targets, targets_length):
        loss_ctc = self.ctc.loss(encoder_out, out_lens, targets,
                                 targets_length, self.data_group)
        metrics = {"loss_ctc": loss_ctc}
        if self.ctc_weight < 1.0:
            loss_att, acc = self._calc_att_loss(encoder_out, out_lens,
                                                targets, targets_length)
            loss = self.ctc_weight * loss_ctc \
                + (1 - self.ctc_weight) * loss_att
            metrics.update(loss_att=loss_att, acc=acc)
        else:
            loss = loss_ctc
            metrics["acc"] = torch.zeros((), device=loss.device)
        metrics["loss"] = loss
        return metrics

    def _calc_att_loss(self, encoder_out, encoder_out_lens, ys_pad,
                       ys_pad_lens):
        """Label-smoothed loss of the left decoder, mixed with the right
        decoder's at reverse_weight; accuracy of the left decoder."""
        ys_in, ys_out = add_sos_eos(ys_pad, ys_pad_lens, self.sos, self.eos)
        tgt_mask = make_attn_mask(ys_pad_lens + 1, ys_in.shape[1],
                                  causal=True)
        memory_mask = make_non_pad_mask(encoder_out_lens,
                                        encoder_out.shape[1])[:, None, :]
        if self.reverse_weight > 0:
            r_ys = reverse_pad_list(ys_pad, ys_pad_lens, IGNORE_ID)
            r_ys_in, r_ys_out = add_sos_eos(r_ys, ys_pad_lens, self.sos,
                                            self.eos)
        else:
            r_ys_in, r_ys_out = torch.zeros_like(ys_in), None
        left, right = self.decoder(encoder_out, memory_mask, ys_in, r_ys_in,
                                   tgt_mask)
        loss_att = label_smoothing_loss(left, ys_out, self.lsm_weight,
                                        IGNORE_ID,
                                        self.length_normalized_loss,
                                        self.data_group)
        if self.reverse_weight > 0:
            r_loss = label_smoothing_loss(right, r_ys_out, self.lsm_weight,
                                          IGNORE_ID,
                                          self.length_normalized_loss,
                                          self.data_group)
            loss_att = (1 - self.reverse_weight) * loss_att \
                + self.reverse_weight * r_loss
        return loss_att, th_accuracy(left, ys_out, IGNORE_ID,
                                     self.data_group)

    # ---- pipeline-parallel split points (parallel/pipeline.py) ----

    def pipeline_head(self, features: torch.Tensor,
                      features_length: torch.Tensor):
        """The encoder's frontend (CMVN and the subsampling embed):
        (xs [B, T', D], pos_emb [1, T', D], out_lens [B])."""
        enc = self.encoder
        if enc.use_global_cmvn:
            features = enc.global_cmvn(features)
        return enc.embed(features.to(enc.dtype), features_length)

    def pipeline_tail(self, xs: torch.Tensor, out_lens: torch.Tensor,
                      targets: torch.Tensor, targets_length: torch.Tensor
                      ) -> dict[str, torch.Tensor]:
        """after_norm on the block stack's output, then the joint loss's
        metrics."""
        return self._joint_loss(self.encoder.encoders.after_norm(xs),
                                out_lens, targets, targets_length)

    # ---- decode ----

    @deterministic
    def encode(self, features: torch.Tensor, features_length: torch.Tensor):
        """(encoder_out [B, T', D] float32, out_lens [B])."""
        out, out_lens, _ = self.encoder(features, features_length)
        return out.float(), out_lens

    @deterministic
    def encode_chunk(self, feat_window, offset, k_caches, v_caches,
                     cache_len, cnn_caches, valid_len=None):
        """Streaming encoder step (TransformerEncoder.forward_chunk):
        (chunk_out [B, c, D] float32, new_k, new_v, new_cnn)."""
        out, k, v, c = self.encoder.forward_chunk(
            feat_window, offset, k_caches, v_caches, cache_len, cnn_caches,
            valid_len)
        return out.float(), k, v, c

    def ctc_log_probs(self, encoder_out: torch.Tensor) -> torch.Tensor:
        return self.ctc.log_softmax(encoder_out.to(self.compute_dtype))

    @deterministic
    def decoder_logits(self, encoder_out, encoder_out_lens, ys_in,
                       ys_in_lens, reverse: bool = False) -> torch.Tensor:
        """Full forward of the left (or right) decoder on sos-prefixed
        ys_in [B, L]. Returns log-softmax scores [B, L, V] float32."""
        tgt_mask = make_attn_mask(ys_in_lens, ys_in.shape[1], causal=True)
        memory_mask = make_non_pad_mask(encoder_out_lens,
                                        encoder_out.shape[1])[:, None, :]
        memory = encoder_out.to(self.compute_dtype)
        dec = self.decoder.right_decoder if reverse \
            else self.decoder.left_decoder
        return torch.log_softmax(dec(ys_in, tgt_mask, memory, memory_mask),
                                 dim=-1)

    @deterministic
    def decoder_init_cache(self, encoder_out: torch.Tensor, beam_batch: int,
                           max_len: int) -> dict:
        """KV cache of the left decoder for `beam_batch` rows (the rows
        of `encoder_out`) and `max_len` positions."""
        return self.decoder.init_cache(encoder_out.to(self.compute_dtype),
                                       beam_batch, max_len)

    @deterministic
    def decoder_step(self, tokens: torch.Tensor, pos: int, cache: dict,
                     encoder_out_lens: torch.Tensor, encoder_t: int
                     ) -> tuple[torch.Tensor, dict]:
        """One left-decoder step: (float32 log-probs [B, V], cache)."""
        memory_mask = make_non_pad_mask(encoder_out_lens,
                                        encoder_t)[:, None, :]
        return self.decoder.forward_step(tokens, pos, cache, memory_mask)


def build_asr_model(model_conf: dict, input_size: int, vocab_size: int,
                    use_global_cmvn: bool = False) -> ASRModel:
    """Construct ASRModel from a `model_conf` dict (defaults as in the
    JAX package's build_asr_model)."""
    mc = dict(model_conf)
    dtype_name = mc.get("compute_dtype", "bfloat16")
    if dtype_name not in DTYPES:
        raise ValueError(f"compute_dtype {dtype_name!r}; have {list(DTYPES)}")
    return ASRModel(
        input_size=input_size,
        vocab_size=vocab_size,
        encoder_num_blocks=mc.get("encoder_num_blocks", 12),
        encoder_num_blocks_share=mc.get("encoder_num_blocks_share", 1),
        decoder_num_blocks=mc.get("decoder_num_blocks", 3),
        r_decoder_num_blocks=mc.get("r_decoder_num_blocks", 0),
        decoder_num_blocks_share=mc.get("decoder_num_blocks_share", 1),
        input_layer=mc.get("input_layer", "conv2d"),
        pos_enc_layer_type=mc.get("pos_enc_layer_type", "rel_pos"),
        d_model=mc.get("d_model", 256),
        attention_heads=mc.get("attention_heads", 4),
        linear_units=mc.get("linear_units", 1024),
        activation_type=mc.get("activation", mc.get("activation_type",
                                                    "swish")),
        macaron_style=mc.get("macaron_style", True),
        use_cnn_module=mc.get("use_cnn_module", True),
        cnn_module_kernel=mc.get("cnn_module_kernel", 15),
        causal=mc.get("causal", False),
        use_global_cmvn=use_global_cmvn,
        tie_word_embedding=mc.get("tie_word_embedding", False),
        compute_dtype=DTYPES[dtype_name],
        dropout_rate=mc.get("dropout_rate", 0.1),
        positional_dropout_rate=mc.get("positional_dropout_rate", 0.0),
        ctc_weight=mc.get("ctc_weight", 0.3),
        lsm_weight=mc.get("lsm_weight", 0.1),
        reverse_weight=mc.get("reverse_weight", 0.0),
        length_normalized_loss=mc.get("length_normalized_loss", False),
        ctc_impl=mc.get("ctc_impl", "optax"),
        static_chunk_size=mc.get("static_chunk_size", 0),
        num_left_chunks=mc.get("num_left_chunks", -1),
        use_dynamic_chunk=mc.get("use_dynamic_chunk", False),
        moe_experts=mc.get("moe_experts", 0),
        moe_top_k=mc.get("moe_top_k", 2),
        moe_capacity_factor=mc.get("moe_capacity_factor", 1.25),
        moe_aux_weight=mc.get("moe_aux_weight", 0.01),
        sequence_sharding=mc.get("sequence_sharding", False),
        encoder_use_adapter=mc.get("encoder_use_adapter", False),
        decoder_use_adapter=mc.get("decoder_use_adapter", False),
        down_size=mc.get("down_size", 64),
        scalar=mc.get("scalar", 0.1),
    )


def _trunc_normal_(p: torch.Tensor, fan_in: int,
                   gen: torch.Generator) -> None:
    """flax's lecun_normal: a normal truncated at 2 standard deviations,
    its scale corrected so the variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=gen)


@torch.no_grad()
def init_parameters(model: ASRModel, generator: torch.Generator) -> None:
    """Fresh weights drawn from `generator` with flax's default
    initializers, so a port run starts where a JAX run of the same
    config would (not from the same bits): Dense and Conv kernels
    lecun_normal over their fan-in, biases 0, LayerNorm 1 and 0,
    embeddings normal with variance 1/d, rel-pos biases xavier_uniform,
    expert banks lecun_normal over their per-expert fan-in (the expert
    axis is a batch axis) with zero biases, a learned adapter scale 1."""
    for module in model.modules():
        if isinstance(module, (Dense, Conv2d)):
            w = module.weight
            _trunc_normal_(w, w[0].numel(), generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, DepthwiseConv1d):
            _trunc_normal_(module.weight, module.weight.shape[0], generator)
            module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, Embed):
            module.weight.normal_(0.0, module.weight.shape[1] ** -0.5,
                                  generator=generator)
        elif isinstance(module, RelPositionMultiHeadedAttention):
            for p in (module.pos_bias_u, module.pos_bias_v):
                nn.init.xavier_uniform_(p, generator=generator)
        elif isinstance(module, MoEPositionwiseFeedForward):
            for w in (module.w_in, module.w_out):
                _trunc_normal_(w, w.shape[1], generator)
            module.b_in.zero_()
            module.b_out.zero_()
        elif isinstance(module, Adapter) and module.learned_scale:
            module.scale.fill_(1.0)
