"""Attention rescoring, batched (PyTorch).
Port of openeat_tpu/decode/rescoring.py without LM fusion:

    score = (1-rw) * att + rw * r_att + ctc_weight * ctc

att sums the left decoder's token log-probs plus the eos log-prob, r_att
reads the right-to-left decoder on the reversed hypothesis, ctc is the
prefix-beam score. The [B, K, L] hypotheses go through each decoder as
one [B*K, L+1] batch.
"""

from __future__ import annotations

import torch

from openeat_torch.utils.common import IGNORE_ID, add_sos_eos, \
    reverse_pad_list


def _gather_token_scores(logp: torch.Tensor, tokens: torch.Tensor,
                         lens: torch.Tensor, eos: int) -> torch.Tensor:
    """Sum of log p(token_j | prefix) over j < len, plus eos at len.
    logp: [M, L+1, V]; tokens: [M, L] (IGNORE_ID padded); lens: [M]."""
    m, l = tokens.shape
    valid = torch.arange(l, device=tokens.device)[None, :] < lens[:, None]
    tok = torch.where(valid, tokens, 0)
    tok_scores = logp[:, :l].gather(2, tok[..., None])[..., 0]
    score = torch.where(valid, tok_scores, 0.0).sum(dim=1)
    # a prefix-beam survivor of an all -1e30 beam can report len L+1;
    # the index is clamped as JAX's gather clamps it
    eos_pos = lens.clamp(max=l)
    return score + logp[torch.arange(m, device=logp.device), eos_pos, eos]


def rescoring_scores(model, encoder_out, encoder_lens, hyps, hyp_lens,
                     ctc_scores, *, ctc_weight: float = 0.5,
                     reverse_weight: float = 0.0) -> torch.Tensor:
    """Combined score of every nbest candidate, [B, K]; candidates with a
    non-finite ctc score are pinned to -1e30."""
    b, k, l = hyps.shape
    flat_hyps = hyps.reshape(b * k, l)
    flat_lens = hyp_lens.reshape(b * k).long()
    ys_in, _ = add_sos_eos(flat_hyps, flat_lens, model.sos, model.eos)
    ys_in_lens = flat_lens + 1
    memory = torch.repeat_interleave(encoder_out, k, dim=0)
    memory_lens = torch.repeat_interleave(encoder_lens, k, dim=0)
    logp = model.decoder_logits(memory, memory_lens, ys_in, ys_in_lens)
    score = _gather_token_scores(logp, flat_hyps, flat_lens, model.eos)
    if reverse_weight > 0:
        r_hyps = reverse_pad_list(flat_hyps, flat_lens, IGNORE_ID)
        r_ys_in, _ = add_sos_eos(r_hyps, flat_lens, model.sos, model.eos)
        r_logp = model.decoder_logits(memory, memory_lens, r_ys_in,
                                      ys_in_lens, reverse=True)
        r_score = _gather_token_scores(r_logp, r_hyps, flat_lens, model.eos)
        score = (1.0 - reverse_weight) * score + reverse_weight * r_score
    score = (score + ctc_weight * ctc_scores.reshape(b * k)).reshape(b, k)
    return torch.where(torch.isfinite(ctc_scores), score, -1.0e30)


def attention_rescoring(model, encoder_out, encoder_lens, hyps, hyp_lens,
                        ctc_scores, *, ctc_weight: float = 0.5,
                        reverse_weight: float = 0.0):
    """Rescore the prefix-beam nbest. hyps: [B, K, L]; hyp_lens,
    ctc_scores: [B, K]. Returns (best hyps [B, L], best lens [B], best
    scores [B], winning index [B]); argmax ties go to the lower index."""
    score = rescoring_scores(model, encoder_out, encoder_lens, hyps,
                             hyp_lens, ctc_scores, ctc_weight=ctc_weight,
                             reverse_weight=reverse_weight)
    best = score.argmax(dim=1)
    rows = torch.arange(hyps.shape[0], device=hyps.device)
    return hyps[rows, best], hyp_lens[rows, best], score[rows, best], best
