"""Byte-pair-encoding tokenizer (host): train, encode, decode.
Port of openeat_tpu/dataset/bpe.py, a copy kept here so that the port
needs nothing of the JAX package.

Greedy lowest-rank merges inside each word with sentencepiece's `▁`
word-boundary prefix. The model file is JSON with the JAX package's
format tag ``openeat_tpu_bpe_v1``, so a file written by either package
loads in the other, and train_bpe breaks count ties between pairs as
the JAX trainer does (the heap's lexicographic order), so that both
learn the same merges in the same order. A sentencepiece ``.model``
path loads through sentencepiece when it is installed and raises
ImportError otherwise.
"""

from __future__ import annotations

import collections
import json
from typing import Iterable

WORD_BOUNDARY = "▁"  # ▁


class BPEModel:
    """Greedy longest-merge BPE with sentencepiece-style ▁ prefix."""

    def __init__(self, merges: list[tuple[str, str]],
                 vocab: list[str] | None = None):
        self.merges = [tuple(m) for m in merges]
        self.ranks = {m: i for i, m in enumerate(self.merges)}
        self.vocab = vocab or []

    # -- encoding --

    def _encode_word(self, word: str) -> list[str]:
        pieces = [WORD_BOUNDARY + word[0]] + list(word[1:]) if word else []
        while len(pieces) > 1:
            best, best_rank = None, None
            for i in range(len(pieces) - 1):
                r = self.ranks.get((pieces[i], pieces[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            pieces[best: best + 2] = [pieces[best] + pieces[best + 1]]
        return pieces

    def encode_as_pieces(self, text: str) -> list[str]:
        out: list[str] = []
        for word in text.strip().split():
            out.extend(self._encode_word(word))
        return out

    def decode_pieces(self, pieces: Iterable[str]) -> str:
        return "".join(pieces).replace(WORD_BOUNDARY, " ").strip()

    # -- persistence --

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"format": "openeat_tpu_bpe_v1",
                       "merges": self.merges, "vocab": self.vocab}, f,
                      ensure_ascii=False)

    @classmethod
    def load(cls, path: str) -> "BPEModel":
        with open(path, encoding="utf-8") as f:
            blob = json.load(f)
        return cls([tuple(m) for m in blob["merges"]], blob.get("vocab"))


def train_bpe(lines: Iterable[str], vocab_size: int = 1000) -> BPEModel:
    """Learn BPE merges from an iterable of text lines (upper-cased,
    split on whitespace; characters up, each word `▁`-prefixed) until
    the symbols and merges number vocab_size or no pair occurs twice.

    Pair counts are kept incrementally: a pair -> word index and a lazy
    max-heap, so a merge touches only the words that hold the pair. Ties
    between counts go to the lexicographically smallest pair.
    """
    import heapq

    word_freq = collections.Counter()
    for line in lines:
        for w in line.strip().upper().split():
            word_freq[w] += 1
    words: list[list[str]] = []   # symbol sequences
    freqs: list[int] = []
    for w, f in word_freq.items():
        words.append([WORD_BOUNDARY + w[0]] + list(w[1:]))
        freqs.append(f)
    symbols = set()
    for t in words:
        symbols.update(t)

    pair_counts: collections.Counter = collections.Counter()
    pair_words: dict[tuple[str, str], set[int]] = {}
    for wi, t in enumerate(words):
        f = freqs[wi]
        for i in range(len(t) - 1):
            p = (t[i], t[i + 1])
            pair_counts[p] += f
            pair_words.setdefault(p, set()).add(wi)

    heap = [(-c, p) for p, c in pair_counts.items()]
    heapq.heapify(heap)

    def push(p):
        heapq.heappush(heap, (-pair_counts[p], p))

    merges: list[tuple[str, str]] = []
    while len(symbols) + len(merges) < vocab_size and heap:
        negc, pair = heapq.heappop(heap)
        cnt = pair_counts.get(pair, 0)
        if cnt != -negc:          # stale heap entry
            if cnt > 0:
                push(pair)
            continue
        if cnt < 2:
            break
        a, b = pair
        merges.append(pair)
        merged = a + b
        symbols.add(merged)
        touched: set[tuple[str, str]] = set()
        for wi in list(pair_words.get(pair, ())):
            t = words[wi]
            f = freqs[wi]
            # remove old pair contributions of this word
            for i in range(len(t) - 1):
                p = (t[i], t[i + 1])
                pair_counts[p] -= f
                touched.add(p)
                s = pair_words.get(p)
                if s is not None:
                    s.discard(wi)
            # apply the merge
            out = []
            i = 0
            while i < len(t):
                if i < len(t) - 1 and t[i] == a and t[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(t[i])
                    i += 1
            words[wi] = out
            # add new pair contributions
            for i in range(len(out) - 1):
                p = (out[i], out[i + 1])
                pair_counts[p] += f
                touched.add(p)
                pair_words.setdefault(p, set()).add(wi)
        pair_counts.pop(pair, None)
        pair_words.pop(pair, None)
        touched.discard(pair)
        for p in touched:
            if pair_counts.get(p, 0) <= 0:
                pair_counts.pop(p, None)
                pair_words.pop(p, None)
            else:
                push(p)
    vocab = sorted(symbols)
    return BPEModel(merges, vocab)


def load_bpe(path: str | None):
    """Load a BPE model: sentencepiece .model if available & binary,
    else the first-party JSON format. None -> None."""
    if path is None:
        return None
    if path.endswith(".model"):
        try:
            import sentencepiece as spm
            sp = spm.SentencePieceProcessor()
            sp.load(path)
            return sp
        except ImportError:
            raise ImportError(
                "sentencepiece not available for .model files; train a "
                "first-party model with openeat_torch.bin.train_bpe")
    return BPEModel.load(path)
