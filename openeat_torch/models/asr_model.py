"""Hybrid CTC/attention ASR model, decode side (PyTorch).
Port of openeat_tpu/models/asr_model.py: build_asr_model, encode,
ctc_log_probs and decoder_logits; sos = eos = vocab_size - 1.

`compute_dtype` sets the activations' dtype; parameters stay float32 and
are cast at use, as flax does. The joint loss comes with training.
"""

from __future__ import annotations

import torch
from torch import nn

from openeat_torch.modules.ctc import CTCHead
from openeat_torch.modules.decoder import BiTransformerDecoder
from openeat_torch.modules.encoder import TransformerEncoder
from openeat_torch.utils.common import get_activation
from openeat_torch.utils.mask import make_attn_mask, make_non_pad_mask

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# model_conf values whose paths are not ported yet, with the slice that
# brings them. A config that sets one of them is refused, not silently
# decoded with a different model.
_NOT_PORTED = {
    "input_layer": ("conv2d", "a later slice (linear, conv2d6, conv2d8)"),
    "pos_enc_layer_type": (("rel_pos", "abs_pos"),
                           "a later slice (no_pos)"),
    "encoder_use_adapter": (False, "the training slice (adapters)"),
    "decoder_use_adapter": (False, "the training slice (adapters)"),
    "moe_experts": (0, "the parallel-layout slice (mixture of experts)"),
    "static_chunk_size": (0, "the streaming slice (chunked attention)"),
}


class ASRModel(nn.Module):
    def __init__(self, input_size: int = 80, vocab_size: int = 4233,
                 encoder_num_blocks: int = 12,
                 encoder_num_blocks_share: int = 1,
                 decoder_num_blocks: int = 3, r_decoder_num_blocks: int = 0,
                 decoder_num_blocks_share: int = 1,
                 pos_enc_layer_type: str = "rel_pos", d_model: int = 256,
                 attention_heads: int = 4, linear_units: int = 1024,
                 activation_type: str = "swish", macaron_style: bool = True,
                 use_cnn_module: bool = True, cnn_module_kernel: int = 15,
                 causal: bool = False, use_global_cmvn: bool = False,
                 tie_word_embedding: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        act = get_activation(activation_type)
        self.vocab_size = vocab_size
        self.compute_dtype = compute_dtype
        self.encoder = TransformerEncoder(
            input_size, d_model, attention_heads, linear_units, act,
            pos_enc_layer_type, macaron_style, use_cnn_module,
            cnn_module_kernel, causal, encoder_num_blocks,
            encoder_num_blocks_share, use_global_cmvn, compute_dtype)
        self.ctc = CTCHead(d_model, vocab_size, compute_dtype)
        self.decoder = BiTransformerDecoder(
            vocab_size, d_model, attention_heads, linear_units, act,
            decoder_num_blocks, r_decoder_num_blocks,
            decoder_num_blocks_share, tie_word_embedding, compute_dtype)

    @property
    def sos(self) -> int:
        return self.vocab_size - 1

    @property
    def eos(self) -> int:
        return self.vocab_size - 1

    def encode(self, features: torch.Tensor, features_length: torch.Tensor):
        """(encoder_out [B, T', D] float32, out_lens [B])."""
        out, out_lens, _ = self.encoder(features, features_length)
        return out.float(), out_lens

    def ctc_log_probs(self, encoder_out: torch.Tensor) -> torch.Tensor:
        return self.ctc.log_softmax(encoder_out.to(self.compute_dtype))

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


def build_asr_model(model_conf: dict, input_size: int, vocab_size: int,
                    use_global_cmvn: bool = False) -> ASRModel:
    """Construct ASRModel from a `model_conf` dict (defaults as in the
    JAX package's build_asr_model)."""
    mc = dict(model_conf)
    for key, (ok, where) in _NOT_PORTED.items():
        if key in mc and mc[key] not in (ok if isinstance(ok, tuple)
                                         else (ok,)):
            raise NotImplementedError(
                f"model_conf {key}={mc[key]!r} is not ported to "
                f"openeat_torch yet; it comes with {where}")
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
    )
