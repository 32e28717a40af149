"""CTC head (PyTorch): projection and frame log-posteriors.
Port of openeat_tpu/modules/ctc.py without the loss, which comes with
training (kernels K1/K2)."""

from __future__ import annotations

import torch
from torch import nn

from openeat_torch.modules.layers import Dense


class CTCHead(nn.Module):
    def __init__(self, d_model: int, vocab_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ctc_lo = Dense(d_model, vocab_size, dtype=dtype)

    def log_softmax(self, hs: torch.Tensor) -> torch.Tensor:
        """Encoder states [B, T, D] -> log-probs [B, T, V] float32."""
        return torch.log_softmax(self.ctc_lo(hs).float(), dim=-1)
