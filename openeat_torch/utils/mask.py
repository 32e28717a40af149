"""Mask utilities (PyTorch). Port of openeat_tpu/utils/mask.py.

Boolean masks are True where a position is VALID (may attend / is real
data).
"""

from __future__ import annotations

import torch

NEG_INF = -1.0e9


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


def mask_finished_scores(scores: torch.Tensor, end_flag: torch.Tensor,
                         eos_index: int = 0) -> torch.Tensor:
    """Freeze finished beams: on a row whose `end_flag` [B*N] is set,
    column `eos_index` of `scores` [B*N, N] becomes 0 and every other
    column NEG_INF (-1e9, as in the JAX package), so the beam's score
    stays what it was."""
    col = torch.arange(scores.shape[-1], device=scores.device)
    frozen = torch.where(col == eos_index, 0.0, NEG_INF).to(scores.dtype)
    finished = end_flag.reshape(end_flag.shape + (1,) * (scores.dim() - 1))
    return torch.where(finished, frozen, scores)


def mask_finished_preds(preds: torch.Tensor, end_flag: torch.Tensor,
                        eos: int) -> torch.Tensor:
    """Force the predictions of finished beams to eos."""
    finished = end_flag.reshape(end_flag.shape
                                + (1,) * (preds.dim() - end_flag.dim()))
    return torch.where(finished, eos, preds)
