"""Transformer language model, autoregressive or masked (PyTorch). Port
of openeat_tpu/models/language_model.py.

Token embedding -> absolute sinusoidal PE -> a stack of vanilla
Transformer blocks (the encoder's Encoder with macaron_style=False and
use_cnn_module=False: pre-norm MHA and FFN, final LayerNorm eps 1e-5)
-> output layer or the tied embedding. autoregressive=True trains causal
next-token prediction on sos-prefixed inputs against eos-terminated
targets; False trains a masked LM on TextCollate's masked inputs with
targets only at the masked positions. The loss is label-smoothed KL.
log_probs (causal) and mlm_log_probs (bidirectional) are the shallow-
fusion scores that attention rescoring reads. Under a mesh's data group
(`data_group`) the loss and accuracy are this rank's shares of the
global batch's (openeat_torch/parallel/tensor_parallel.py). Modules are
named
`embed`, `pos_enc`, `encoder` and `output_layer`, as in the flax tree,
so openeat_torch/utils/param_bridge.py carries a flax LM across.
"""

from __future__ import annotations

import torch
from torch import nn

from openeat_torch.models.asr_model import DTYPES, deterministic
from openeat_torch.modules.embedding import PositionalEncoding
from openeat_torch.modules.encoder import Encoder
from openeat_torch.modules.label_smoothing import label_smoothing_loss
from openeat_torch.modules.layers import Dense, Embed
from openeat_torch.utils.common import (IGNORE_ID, add_sos_eos,
                                        get_activation, th_accuracy)
from openeat_torch.utils.mask import make_attn_mask


class LanguageModel(nn.Module):
    def __init__(self, vocab_size: int, d_model: int = 256,
                 attention_heads: int = 4, linear_units: int = 1024,
                 num_blocks: int = 6, num_blocks_share: int = 1,
                 dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.0,
                 activation_type: str = "relu", autoregressive: bool = True,
                 lsm_weight: float = 0.1,
                 length_normalized_loss: bool = False,
                 tie_word_embedding: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.autoregressive = autoregressive
        self.lsm_weight = lsm_weight
        self.length_normalized_loss = length_normalized_loss
        self.tie_word_embedding = tie_word_embedding
        self.compute_dtype = compute_dtype
        self.data_group = None
        self.embed = Embed(vocab_size, d_model, compute_dtype)
        self.pos_enc = PositionalEncoding(d_model, positional_dropout_rate)
        self.encoder = Encoder(
            d_model, attention_heads, linear_units,
            get_activation(activation_type), macaron_style=False,
            use_cnn_module=False, cnn_module_kernel=15, causal=False,
            num_blocks=num_blocks, num_blocks_share=num_blocks_share,
            dtype=compute_dtype, dropout_rate=dropout_rate)
        if not tie_word_embedding:
            self.output_layer = Dense(d_model, vocab_size,
                                      dtype=compute_dtype)

    @property
    def sos(self) -> int:
        return self.vocab_size - 1

    @property
    def eos(self) -> int:
        return self.vocab_size - 1

    def encode(self, tokens: torch.Tensor, lengths: torch.Tensor,
               causal: bool = True) -> torch.Tensor:
        """tokens [B, L] -> logits [B, L, V] float32."""
        x, _ = self.pos_enc(self.embed(tokens))
        mask = make_attn_mask(lengths, tokens.shape[1],
                              causal=causal and self.autoregressive)
        pos_emb = torch.zeros((1, tokens.shape[1], self.d_model),
                              dtype=x.dtype, device=x.device)
        h = self.encoder(x, mask, pos_emb)
        head = self.embed.attend if self.tie_word_embedding \
            else self.output_layer
        return head(h).float()

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor,
                masked_targets: torch.Tensor | None = None
                ) -> dict[str, torch.Tensor]:
        """Training loss: {"loss", "acc"}."""
        if self.autoregressive:
            ys_in, targets = add_sos_eos(tokens, lengths, self.sos, self.eos)
            logits = self.encode(ys_in, lengths + 1, causal=True)
        else:
            if masked_targets is None:
                raise ValueError("a masked LM needs masked_targets")
            inputs = torch.where(tokens == IGNORE_ID, self.eos, tokens)
            logits = self.encode(inputs, lengths, causal=False)
            targets = masked_targets
        loss = label_smoothing_loss(logits, targets, self.lsm_weight,
                                    IGNORE_ID, self.length_normalized_loss,
                                    self.data_group)
        return {"loss": loss, "acc": th_accuracy(logits, targets, IGNORE_ID,
                                                 self.data_group)}

    @deterministic
    def log_probs(self, tokens: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
        """Causal log-softmax scores [B, L, V] for shallow fusion."""
        return torch.log_softmax(self.encode(tokens, lengths, causal=True),
                                 dim=-1)

    @deterministic
    def mlm_log_probs(self, tokens: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
        """Bidirectional (masked-LM) scores for pseudo-likelihood
        fusion."""
        return torch.log_softmax(self.encode(tokens, lengths, causal=False),
                                 dim=-1)


def build_language_model(model_conf: dict, vocab_size: int) -> LanguageModel:
    """Construct a LanguageModel from a `model_conf` dict (defaults and
    key names as in the JAX package's build_language_model)."""
    mc = dict(model_conf)
    dtype_name = mc.get("compute_dtype", "bfloat16")
    if dtype_name not in DTYPES:
        raise ValueError(f"compute_dtype {dtype_name!r}; have {list(DTYPES)}")
    return LanguageModel(
        vocab_size=vocab_size,
        d_model=mc.get("d_model", 256),
        attention_heads=mc.get("attention_heads", 4),
        linear_units=mc.get("linear_units", 1024),
        num_blocks=mc.get("num_blocks", mc.get("encoder_num_blocks", 6)),
        num_blocks_share=mc.get("num_blocks_share",
                                mc.get("encoder_num_blocks_share", 1)),
        dropout_rate=mc.get("dropout_rate", 0.1),
        activation_type=mc.get("activation", "relu"),
        autoregressive=mc.get("autoregressive", True),
        lsm_weight=mc.get("lsm_weight", 0.1),
        length_normalized_loss=mc.get("length_normalized_loss", False),
        tie_word_embedding=mc.get("tie_word_embedding", False),
        compute_dtype=DTYPES[dtype_name],
    )
