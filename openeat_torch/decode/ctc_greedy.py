"""CTC greedy search (PyTorch). Port of openeat_tpu/decode/ctc_greedy.py:
per-frame argmax (first index on ties), pad frames forced to blank,
then the batched collapse of runs and blanks."""

from __future__ import annotations

import torch

from openeat_torch.utils.common import IGNORE_ID, ctc_collapse


def ctc_greedy_search(ctc_log_probs: torch.Tensor, lens: torch.Tensor,
                      blank_id: int = 0, return_times: bool = False):
    """ctc_log_probs: [B, T, V]; lens: [B].
    Returns (hyps [B, T] IGNORE_ID padded, hyp_lens [B]); return_times
    appends each kept token's emission frame [B, T] (the first frame of
    its argmax run, the onset; 0 on pad lanes)."""
    t = ctc_log_probs.shape[1]
    best = ctc_log_probs.argmax(dim=-1)
    pad = torch.arange(t, device=best.device)[None, :] >= lens[:, None]
    out = ctc_collapse(torch.where(pad, blank_id, best), blank_id,
                       IGNORE_ID, return_positions=return_times)
    hyps = out[0] if return_times else out
    hyp_lens = (hyps != IGNORE_ID).sum(dim=-1)
    return (hyps, hyp_lens, out[1]) if return_times else (hyps, hyp_lens)
