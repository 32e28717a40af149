"""CTC head (PyTorch): projection, frame log-posteriors and the loss.
Port of openeat_tpu/modules/ctc.py.

`impl` is model_conf.ctc_impl, as in the JAX head: "parallel" runs the
log-semiring scan of openeat_torch/ops/ctc_parallel.py (plain torch
ops); every other value ("optax", the default, and "native", JAX's
Pallas kernel) runs the port's own CTC, openeat_torch/ops/ctc_loss.py
(kernels K1/K2 on the card, their plain version on the CPU). Both
compute the same function.
"""

from __future__ import annotations

import torch
from torch import nn

from openeat_torch.modules.layers import Dense
from openeat_torch.ops.ctc_loss import ctc_loss
from openeat_torch.ops.ctc_parallel import ctc_loss_parallel
from openeat_torch.parallel.tensor_parallel import global_count


class CTCHead(nn.Module):
    def __init__(self, d_model: int, vocab_size: int,
                 dtype: torch.dtype = torch.float32,
                 length_normalized_loss: bool = False, blank_id: int = 0,
                 impl: str = "optax"):
        super().__init__()
        self.ctc_lo = Dense(d_model, vocab_size, dtype=dtype)
        self.impl = impl
        self.length_normalized_loss = length_normalized_loss
        self.blank_id = blank_id

    def log_softmax(self, hs: torch.Tensor) -> torch.Tensor:
        """Encoder states [B, T, D] -> log-probs [B, T, V] float32."""
        return torch.log_softmax(self.ctc_lo(hs).float(), dim=-1)

    def loss(self, hs: torch.Tensor, hlens: torch.Tensor, ys: torch.Tensor,
             ys_lens: torch.Tensor, group=None) -> torch.Tensor:
        """Scalar CTC loss. hs [B, T, D]; hlens [B]; ys [B, L] (any pad);
        ys_lens [B].

        zero_infinity semantics: a sequence with fewer frames than labels
        plus the blanks its repeats need contributes 0. Normalised per
        token (mean of per_seq / max(ys_lens, 1)) when
        length_normalized_loss, else sum / B. With a data `group`, B is
        the group's global batch and the result this rank's share
        (openeat_torch/parallel/tensor_parallel.py)."""
        log_probs = self.log_softmax(hs)
        b, t = log_probs.shape[:2]
        l = ys.shape[1]
        pos = torch.arange(l, device=ys.device)[None, :]
        labels = torch.where(pos >= ys_lens[:, None], 0, ys).long()
        if self.impl == "parallel":
            frames = torch.arange(t, device=hlens.device)[None, :]
            per_seq = ctc_loss_parallel(
                log_probs, (frames >= hlens[:, None]).float(), labels,
                (pos >= ys_lens[:, None]).float(), self.blank_id)
        else:
            per_seq = ctc_loss(log_probs, hlens, labels, ys_lens,
                               self.blank_id)
        repeats = ((labels[:, 1:] == labels[:, :-1])
                   & (pos[:, 1:] < ys_lens[:, None])).sum(dim=1)
        feasible = hlens >= ys_lens + repeats
        per_seq = torch.where(feasible & torch.isfinite(per_seq), per_seq,
                              0.0)
        if self.length_normalized_loss:
            per_seq = per_seq / ys_lens.clamp(min=1)
            if group is None:
                return per_seq.mean()
        return per_seq.sum() / global_count(b, group)
