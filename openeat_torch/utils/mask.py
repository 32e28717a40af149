"""Mask utilities (PyTorch). Port of openeat_tpu/utils/mask.py.

Boolean masks are True where a position is VALID (may attend / is real
data). The chunk masks are the streaming-style training masks: a query
attends within its chunk and `num_left_chunks` chunks before it (-1:
all of them).
"""

from __future__ import annotations

import torch

NEG_INF = -1.0e9


def make_non_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """True at valid (non-pad) positions; [B, max_len]."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return pos < lengths.long()[:, None]


def chunk_mask(size: int, chunk_size: int, num_left_chunks: int = -1,
               device=None) -> torch.Tensor:
    """[size, size] bool chunked-attention mask for a fixed chunk size."""
    pos = torch.arange(size, device=device)
    q, k = (pos // chunk_size)[:, None], (pos // chunk_size)[None, :]
    m = k <= q
    if num_left_chunks >= 0:
        m = m & (k >= q - num_left_chunks)
    return m


def dynamic_chunk_mask(size: int, chunk_size: torch.Tensor | int,
                       num_left_chunks: torch.Tensor | int = -1
                       ) -> torch.Tensor:
    """chunk_mask with the chunk size (clamped to >= 1) and the left
    chunks given as tensors, so a chunk size drawn on the device builds
    its mask without a host sync."""
    cs = torch.clamp(torch.as_tensor(chunk_size), min=1)
    pos = torch.arange(size, device=cs.device)
    q, k = (pos // cs)[:, None], (pos // cs)[None, :]
    m = k <= q
    left = torch.as_tensor(num_left_chunks, device=cs.device)
    return torch.where(left >= 0, m & (k >= q - left), m)


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
