"""Batched attention beam search (PyTorch). Port of
openeat_tpu/decode/attention_beam.py.

The encoder output is repeated to B*N beams; each step scores one
position, keeps the top N tokens of every beam (finished beams frozen to
[0, -1e9, ...] with eos as their only continuation), then the top N of
the N*N candidates of each utterance, and stops when every beam has
emitted eos or after max_steps. The best beam is picked by its raw score
plus length_penalty * its length.

`attention_beam_search_cached` scores a step with one single-position
decoder evaluation against KV caches (ASRModel.decoder_step); only the
self-attention caches follow their beams. `attention_beam_search`
recomputes the whole prefix every step and is kept as the cache's
oracle. Both loop in Python, one host sync a step for the "all
finished" test. Both top-k stages use a stable descending sort, which
breaks ties by the lower index as lax.top_k does; torch.topk promises
no order among ties.
"""

from __future__ import annotations

import torch

from openeat_torch.decode.ctc_prefix_beam import _top_k
from openeat_torch.utils.common import IGNORE_ID
from openeat_torch.utils.mask import (NEG_INF, mask_finished_preds,
                                      mask_finished_scores)


def _select_best(final_tokens: torch.Tensor, final_scores: torch.Tensor,
                 b: int, n: int, eos: int, length_penalty: float):
    """(hyps [B, L] IGNORE_ID padded, lens [B], scores [B]) of the beam
    with the best score + length_penalty * length; a hypothesis ends at
    its first eos."""
    tokens = final_tokens.view(b, n, -1)[:, :, 1:]
    lens = (tokens != eos).long().cumprod(dim=2).sum(dim=2)     # [B, N]
    scores = final_scores.view(b, n)
    sel = scores + length_penalty * lens.to(scores.dtype)
    best = _top_k(sel, 1)[1][:, 0]
    rows = torch.arange(b, device=tokens.device)
    best_lens = lens[rows, best]
    pos = torch.arange(tokens.shape[2], device=tokens.device)[None, :]
    hyps = torch.where(pos < best_lens[:, None], tokens[rows, best],
                       IGNORE_ID)
    return hyps, best_lens, scores[rows, best]


def _init_beams(b: int, n: int, max_steps: int, sos: int, eos: int,
                device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tokens [B*N, max_steps + 1] (sos, then eos), scores [B*N] (0 for
    each utterance's first beam, NEG_INF for the rest), finished."""
    tokens = torch.full((b * n, max_steps + 1), eos, dtype=torch.long,
                        device=device)
    tokens[:, 0] = sos
    scores = torch.full((b, n), NEG_INF, device=device)
    scores[:, 0] = 0.0
    return tokens, scores.view(-1), torch.zeros(b * n, dtype=torch.bool,
                                                device=device)


def _advance(tokens, scores, finished, logp, i: int, b: int, n: int,
             eos: int):
    """One step of the two-stage search on log-probs [B*N, V] at
    position i. Returns (tokens, scores, finished, src), src [B*N] being
    the beam each new beam came from."""
    dev = tokens.device
    top_lp, top_tok = _top_k(logp, n)                            # [M, N]
    top_lp = mask_finished_scores(top_lp, finished, eos_index=0)
    top_tok = mask_finished_preds(top_tok, finished, eos)
    cand = (scores[:, None] + top_lp).reshape(b, n * n)
    best_sc, best_idx = _top_k(cand, n)                          # [B, N]
    beam_idx = best_idx // n
    tok_idx = best_idx % n
    rows = torch.arange(b, device=dev)[:, None]
    src = (rows * n + beam_idx).reshape(-1)
    new_tokens = tokens[src]
    new_tok = top_tok.reshape(b, n, n)[rows, beam_idx, tok_idx].reshape(-1)
    new_tokens[:, i + 1] = new_tok
    new_finished = finished[src] | (new_tok == eos)
    return new_tokens, best_sc.reshape(-1), new_finished, src


def attention_beam_search(decoder_step_fn, encoder_out: torch.Tensor,
                          encoder_lens: torch.Tensor, *, beam_size: int,
                          sos: int, eos: int, max_steps: int,
                          length_penalty: float = 0.0):
    """Search over `decoder_step_fn(tokens [M, L+1], memory, memory_lens)
    -> log-probs [M, L+1, V]`, the full-prefix causal decoder. Returns
    (best tokens [B, max_steps] IGNORE_ID padded, lens [B], scores
    [B])."""
    b = encoder_out.shape[0]
    n = beam_size
    memory = torch.repeat_interleave(encoder_out, n, dim=0)
    memory_lens = torch.repeat_interleave(encoder_lens, n, dim=0)
    tokens, scores, finished = _init_beams(b, n, max_steps, sos, eos,
                                           encoder_out.device)
    i = 0
    while i < max_steps and not bool(finished.all()):
        logp = decoder_step_fn(tokens, memory, memory_lens)[:, i]
        tokens, scores, finished, _ = _advance(tokens, scores, finished,
                                               logp, i, b, n, eos)
        i += 1
    return _select_best(tokens, scores, b, n, eos, length_penalty)


def attention_beam_search_cached(model, encoder_out: torch.Tensor,
                                 encoder_lens: torch.Tensor, *,
                                 beam_size: int, max_steps: int,
                                 length_penalty: float = 0.0):
    """KV-cached search: each step is one single-position decoder
    evaluation (model.decoder_step). Gives the hypotheses of
    attention_beam_search."""
    b, t, _ = encoder_out.shape
    n = beam_size
    m = b * n
    eos = model.eos
    memory = torch.repeat_interleave(encoder_out, n, dim=0)
    memory_lens = torch.repeat_interleave(encoder_lens, n, dim=0)
    cache = model.decoder_init_cache(memory, m, max_steps + 1)
    tokens, scores, finished = _init_beams(b, n, max_steps, model.sos, eos,
                                           encoder_out.device)
    i = 0
    while i < max_steps and not bool(finished.all()):
        logp, cache = model.decoder_step(tokens[:, i], i, cache, memory_lens,
                                         t)
        tokens, scores, finished, src = _advance(tokens, scores, finished,
                                                 logp, i, b, n, eos)
        # the cross K/V rows are equal within an utterance: no gather
        cache = {"cross": cache["cross"],
                 "self_k": [c[src] for c in cache["self_k"]],
                 "self_v": [c[src] for c in cache["self_v"]]}
        i += 1
    return _select_best(tokens, scores, b, n, eos, length_penalty)


def make_decoder_step_fn(model):
    """Full-prefix causal decoder scorer for ASRModel."""
    def fn(tokens, memory, memory_lens):
        lens = torch.full((tokens.shape[0],), tokens.shape[1],
                          dtype=torch.long, device=tokens.device)
        return model.decoder_logits(memory, memory_lens, tokens, lens)
    return fn


def adaptive_max_steps(greedy_lens, *, factor: float = 1.25,
                       margin: int = 4, bucket: int = 8,
                       cap: int | None = None) -> int:
    """Step bound from CTC-greedy hypothesis lengths: factor * the
    longest + margin, rounded up to a multiple of `bucket`, at most
    `cap`."""
    lens = torch.as_tensor(greedy_lens)
    m = int(lens.max()) if lens.numel() else 0
    s = int(m * factor) + margin
    s = max(bucket, ((s + bucket - 1) // bucket) * bucket)
    return min(s, cap) if cap is not None else s


def recognize(model, encoder_out, encoder_lens, *, beam_size: int = 10,
              max_steps: int | None = None, use_cache: bool = True,
              length_penalty: float = 0.0):
    """The attention decode mode: (hyps [B, max_steps], lens [B], scores
    [B]); max_steps defaults to the encoder length."""
    if max_steps is None:
        max_steps = int(encoder_out.shape[1])
    if use_cache:
        return attention_beam_search_cached(
            model, encoder_out, encoder_lens, beam_size=beam_size,
            max_steps=max_steps, length_penalty=length_penalty)
    return attention_beam_search(
        make_decoder_step_fn(model), encoder_out, encoder_lens,
        beam_size=beam_size, sos=model.sos, eos=model.eos,
        max_steps=max_steps, length_penalty=length_penalty)
