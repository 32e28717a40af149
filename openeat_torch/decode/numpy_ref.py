"""Plain numpy/python reference decoders, used as test oracles. Port of
openeat_tpu/decode/numpy_ref.py.

These implement the textbook algorithms with python dicts and loops,
independent of the batched searches in this package, as the reference
computes them (openeat/models/asr_model.py:297-396), so that a search
can be held to them token for token on small inputs, on the CPU or on
the card's output. Nothing on a decode path calls them. The module
imports numpy and the port's own `log_add` and
`remove_duplicates_and_blank`, and nothing else: no torch kernel runs,
and the tie order is the JAX package's (numpy's argsort, then python's
stable sort).
"""

from __future__ import annotations


import numpy as np

from openeat_torch.utils.common import log_add, remove_duplicates_and_blank


def ctc_greedy_ref(log_probs: np.ndarray, length: int,
                   blank_id: int = 0) -> list[int]:
    best = np.argmax(log_probs[:length], axis=-1)
    return remove_duplicates_and_blank(best, blank_id)


def ctc_prefix_beam_ref(log_probs: np.ndarray, length: int,
                        beam_size: int = 10, blank_id: int = 0
                        ) -> list[tuple[tuple[int, ...], float]]:
    """Dict-based prefix beam search (reference asr_model.py:359-394).

    Returns [(prefix, log_prob)] best-first, len == beam_size.
    """
    ninf = -float("inf")
    cur = {(): (0.0, ninf)}  # prefix -> (pb, pnb)
    for t in range(length):
        lp = log_probs[t]
        nxt: dict[tuple, tuple[float, float]] = {}

        def upd(prefix, pb=None, pnb=None):
            b, nb = nxt.get(prefix, (ninf, ninf))
            if pb is not None:
                b = log_add([b, pb])
            if pnb is not None:
                nb = log_add([nb, pnb])
            nxt[prefix] = (b, nb)

        top = np.argsort(lp)[::-1][:beam_size]
        for prefix, (pb, pnb) in cur.items():
            last = prefix[-1] if prefix else None
            for v in top:
                v = int(v)
                p = float(lp[v])
                if v == blank_id:
                    upd(prefix, pb=log_add([pb, pnb]) + p)
                elif v == last:
                    upd(prefix, pnb=pnb + p)
                    upd(prefix + (v,), pnb=pb + p)
                else:
                    upd(prefix + (v,), pnb=log_add([pb, pnb]) + p)
        ranked = sorted(nxt.items(), key=lambda kv: log_add(list(kv[1])),
                        reverse=True)
        cur = dict(ranked[:beam_size])
    out = [(p, log_add(list(v))) for p, v in cur.items()]
    out.sort(key=lambda kv: kv[1], reverse=True)
    while len(out) < beam_size:
        out.append(((), -float("inf")))
    return out[:beam_size]


def attention_beam_ref(step_scores_fn, batch_size: int, beam_size: int,
                       sos: int, eos: int, max_steps: int) -> list[list[int]]:
    """Plain python beam search oracle.

    step_scores_fn(prefixes: list[list[int]]) -> np.ndarray [n, V] of
    log-probs for the next token of each prefix (already sos-prefixed).
    """
    hyps = [[([sos], 0.0, False)] for _ in range(batch_size)]
    for _ in range(max_steps):
        if all(all(done for _, _, done in beams) for beams in hyps):
            break
        flat = [h for beams in hyps for (h, _, _) in beams]
        scores = step_scores_fn(flat)
        idx = 0
        new_hyps = []
        for beams in hyps:
            cands = []
            for (h, s, done) in beams:
                sc = scores[idx]
                idx += 1
                if done:
                    cands.append((h, s, True))
                    continue
                for v in np.argsort(sc)[::-1][: beam_size]:
                    v = int(v)
                    cands.append((h + [v], s + float(sc[v]), v == eos))
            cands.sort(key=lambda x: x[1], reverse=True)
            new_hyps.append(cands[:beam_size])
        hyps = new_hyps
    out = []
    for beams in hyps:
        best = max(beams, key=lambda x: x[1])
        h = best[0][1:]
        h = h[: h.index(eos)] if eos in h else h
        out.append(h)
    return out
