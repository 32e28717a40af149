"""CTC head (PyTorch): projection, frame log-posteriors and the loss.
Port of openeat_tpu/modules/ctc.py.

The loss always runs the port's own CTC, openeat_torch/ops/ctc_loss.py
(kernels K1/K2 on the card, their plain version on the CPU). The JAX
head's ``ctc_impl`` choice (optax, the Pallas kernel or the parallel
scan) computes the same function; a config may still set it, and the
port ignores it.
"""

from __future__ import annotations

import torch
from torch import nn

from openeat_torch.modules.layers import Dense
from openeat_torch.ops.ctc_loss import ctc_loss


class CTCHead(nn.Module):
    def __init__(self, d_model: int, vocab_size: int,
                 dtype: torch.dtype = torch.float32,
                 length_normalized_loss: bool = False, blank_id: int = 0):
        super().__init__()
        self.ctc_lo = Dense(d_model, vocab_size, dtype=dtype)
        self.length_normalized_loss = length_normalized_loss
        self.blank_id = blank_id

    def log_softmax(self, hs: torch.Tensor) -> torch.Tensor:
        """Encoder states [B, T, D] -> log-probs [B, T, V] float32."""
        return torch.log_softmax(self.ctc_lo(hs).float(), dim=-1)

    def loss(self, hs: torch.Tensor, hlens: torch.Tensor, ys: torch.Tensor,
             ys_lens: torch.Tensor) -> torch.Tensor:
        """Scalar CTC loss. hs [B, T, D]; hlens [B]; ys [B, L] (any pad);
        ys_lens [B].

        zero_infinity semantics: a sequence with fewer frames than labels
        plus the blanks its repeats need contributes 0. Normalised per
        token (mean of per_seq / max(ys_lens, 1)) when
        length_normalized_loss, else sum / B."""
        log_probs = self.log_softmax(hs)
        b = log_probs.shape[0]
        l = ys.shape[1]
        pos = torch.arange(l, device=ys.device)[None, :]
        labels = torch.where(pos >= ys_lens[:, None], 0, ys).long()
        per_seq = ctc_loss(log_probs, hlens, labels, ys_lens, self.blank_id)
        repeats = ((labels[:, 1:] == labels[:, :-1])
                   & (pos[:, 1:] < ys_lens[:, None])).sum(dim=1)
        feasible = hlens >= ys_lens + repeats
        per_seq = torch.where(feasible & torch.isfinite(per_seq), per_seq,
                              0.0)
        if self.length_normalized_loss:
            return (per_seq / ys_lens.clamp(min=1)).mean()
        return per_seq.sum() / b
