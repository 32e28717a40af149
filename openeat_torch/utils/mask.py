"""Mask utilities (PyTorch). Port of openeat_tpu/utils/mask.py.

Boolean masks are True where a position is VALID (may attend / is real
data).
"""

from __future__ import annotations

import torch


def make_non_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """True at valid (non-pad) positions; [B, max_len]."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return pos < lengths.long()[:, None]


def make_attn_mask(lengths: torch.Tensor, max_len: int,
                   causal: bool = False) -> torch.Tensor:
    """Padding (+causal) attention mask; [B, T, T] bool, True = attend."""
    mask = make_non_pad_mask(lengths, max_len)[:, None, :]
    if causal:
        sub = torch.ones(max_len, max_len, dtype=torch.bool,
                         device=lengths.device).tril()
        return mask & sub[None]
    return mask.expand(-1, max_len, -1)
