"""N-gram language model scorers (host). A copy of
openeat_tpu/lm/ngram.py, which imports no JAX, kept here so that the
port needs nothing of the JAX package.

- ArpaLM: text or gzip ARPA with Katz backoff, and kenlm's
  `score(sentence, bos, eos)` log10 API;
- BinaryNgramLM: the first-party mmap-able binary format (sorted 64-bit
  FNV-1a n-gram hashes with float32 prob/backoff arrays per order,
  searchsorted lookups), written by `ArpaLM.save_binary`;
- `load_lm(path)`: dispatch on the file's first bytes. A kenlm `.klm`
  binary goes to the `kenlm` package when it is installed and raises
  otherwise.

Bin/recognize.py adds `lm_weight * score` of each n-best candidate on
the host (--ngram_lm), in log10 units as the JAX package does.
"""

from __future__ import annotations

import gzip
import json
import math

import numpy as np

LOG10 = math.log(10.0)

KENLM_MAGIC = b"mmap lm http://kheafield.com"
BINARY_MAGIC = b"OPENEAT-NGRAM-v1"

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def fnv1a64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def _gram_hash(words: tuple[str, ...]) -> int:
    return fnv1a64("\x00".join(words).encode("utf-8"))


class _BackoffScorer:
    """Katz backoff scoring over an abstract n-gram lookup."""

    order: int

    def _lookup(self, words: tuple[str, ...]
                ) -> tuple[float, float] | None:
        raise NotImplementedError

    def _word_logprob(self, context: tuple[str, ...], word: str) -> float:
        """log10 P(word | context): longest matching n-gram's probability,
        accumulating backoff weights of the contexts that failed."""
        total_bo = 0.0
        while True:
            hit = self._lookup(context + (word,))
            if hit is not None:
                return total_bo + hit[0]
            if not context:
                unk = self._lookup(("<unk>",))
                return total_bo + (unk[0] if unk is not None else -7.0)
            ctx_hit = self._lookup(context)
            # missing backoff weight means 1.0 (log 0) in ARPA
            # semantics; tools/train_ngram.estimate() emits None for
            # grams with no continuation, while the file loader stores
            # 0.0 — accept both so estimate()->ArpaLM composes without
            # a file round-trip
            if ctx_hit is not None and ctx_hit[1] is not None:
                total_bo += ctx_hit[1]
            context = context[1:]

    def score(self, sentence: str, bos: bool = True, eos: bool = True
              ) -> float:
        """Total log10 prob of the sentence (kenlm-compatible API)."""
        words = sentence.split()
        if eos:
            words = words + ["</s>"]
        context: tuple[str, ...] = ("<s>",) if bos else ()
        total = 0.0
        for w in words:
            ctx = context[-(self.order - 1):] if self.order > 1 else ()
            total += self._word_logprob(ctx, w)
            context = context + (w,)
        return total

    def score_nats(self, sentence: str, **kw) -> float:
        return self.score(sentence, **kw) * LOG10


class ArpaLM(_BackoffScorer):
    def __init__(self, ngrams: dict[tuple[str, ...], tuple[float, float]],
                 order: int):
        self.ngrams = ngrams  # tuple(words) -> (log10 prob, log10 backoff)
        self.order = order

    def _lookup(self, words):
        return self.ngrams.get(words)

    def save_binary(self, path: str) -> None:
        """Write the mmap-able binary format (BinaryNgramLM.load)."""
        by_order: dict[int, list[tuple[int, float, float]]] = {}
        for words, (prob, bo) in self.ngrams.items():
            by_order.setdefault(len(words), []).append(
                (_gram_hash(words), prob, bo))
        counts = [len(by_order.get(n, ())) for n in range(1, self.order + 1)]
        header = json.dumps({"order": self.order,
                             "counts": counts}).encode("utf-8")
        with open(path, "wb") as f:
            f.write(BINARY_MAGIC)
            f.write(len(header).to_bytes(4, "little"))
            f.write(header)
            pad = (-f.tell()) % 8
            f.write(b"\x00" * pad)
            for n in range(1, self.order + 1):
                entries = sorted(by_order.get(n, ()))
                keys = np.asarray([e[0] for e in entries], np.uint64)
                probs = np.asarray([e[1] for e in entries], np.float32)
                bos_ = np.asarray([e[2] for e in entries], np.float32)
                f.write(keys.tobytes())
                f.write(probs.tobytes())
                f.write(bos_.tobytes())
                f.write(b"\x00" * ((-f.tell()) % 8))

    @classmethod
    def load(cls, path: str) -> "ArpaLM":
        opener = gzip.open if path.endswith(".gz") else open
        ngrams: dict[tuple[str, ...], tuple[float, float]] = {}
        order = 0
        cur_n = 0
        with opener(path, "rt", encoding="utf-8") as f:
            section = None
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line == "\\data\\":
                    section = "data"
                    continue
                if line.startswith("\\") and line.endswith("-grams:"):
                    cur_n = int(line[1:].split("-")[0])
                    order = max(order, cur_n)
                    section = "ngrams"
                    continue
                if line == "\\end\\":
                    break
                if section == "ngrams" and cur_n > 0:
                    parts = line.split("\t")
                    if len(parts) < 2:
                        parts = line.split()
                        if len(parts) < cur_n + 1:
                            continue
                        prob = float(parts[0])
                        words = tuple(parts[1: 1 + cur_n])
                        backoff = (float(parts[1 + cur_n])
                                   if len(parts) > 1 + cur_n else 0.0)
                    else:
                        prob = float(parts[0])
                        words = tuple(parts[1].split())
                        backoff = float(parts[2]) if len(parts) > 2 else 0.0
                    ngrams[words] = (prob, backoff)
        if order == 0:
            raise ValueError(f"{path}: no n-gram sections found")
        return cls(ngrams, order)


class BinaryNgramLM(_BackoffScorer):
    """mmap-backed binary n-gram model (sorted-hash searchsorted lookup).

    Load is O(header) — the per-order key/prob/backoff arrays stay on
    disk via np.memmap, so a multi-GB model opens in milliseconds (the
    property kenlm's .klm binaries exist for)."""

    def __init__(self, keys: list[np.ndarray], probs: list[np.ndarray],
                 backoffs: list[np.ndarray]):
        self.keys = keys          # per order: sorted uint64 hashes
        self.probs = probs
        self.backoffs = backoffs
        self.order = len(keys)

    @classmethod
    def load(cls, path: str) -> "BinaryNgramLM":
        with open(path, "rb") as f:
            magic = f.read(len(BINARY_MAGIC))
            if magic != BINARY_MAGIC:
                raise ValueError(f"{path}: not an openeat binary ngram")
            hlen = int.from_bytes(f.read(4), "little")
            header = json.loads(f.read(hlen).decode("utf-8"))
            offset = f.tell()
            offset += (-offset) % 8
        counts = header["counts"]
        keys, probs, backoffs = [], [], []
        for cnt in counts:
            k = np.memmap(path, np.uint64, "r", offset, (cnt,))
            offset += 8 * cnt
            p = np.memmap(path, np.float32, "r", offset, (cnt,))
            offset += 4 * cnt
            b = np.memmap(path, np.float32, "r", offset, (cnt,))
            offset += 4 * cnt
            offset += (-offset) % 8
            keys.append(k)
            probs.append(p)
            backoffs.append(b)
        return cls(keys, probs, backoffs)

    def _lookup(self, words):
        n = len(words)
        if n > self.order:
            return None
        keys = self.keys[n - 1]
        if len(keys) == 0:
            return None
        h = np.uint64(_gram_hash(words))
        i = int(np.searchsorted(keys, h))
        if i < len(keys) and keys[i] == h:
            return float(self.probs[n - 1][i]), float(self.backoffs[n - 1][i])
        return None


def load_lm(path: str):
    """Format-dispatched n-gram load: text/gzip ARPA, openeat binary, or
    kenlm .klm (delegated to the kenlm package when installed)."""
    with (gzip.open(path, "rb") if path.endswith(".gz")
          else open(path, "rb")) as f:
        head = f.read(max(len(BINARY_MAGIC), len(KENLM_MAGIC)))
    if head.startswith(BINARY_MAGIC):
        return BinaryNgramLM.load(path)
    if head.startswith(KENLM_MAGIC):
        try:
            import kenlm  # type: ignore
        except ImportError:
            raise ValueError(
                f"{path} is a kenlm binary model and the kenlm package is "
                "not installed. Either install kenlm, or convert the "
                "source ARPA with tools/build_binary_lm.py to the "
                "first-party binary format (same fast-mmap load).")
        return kenlm.Model(path)
    return ArpaLM.load(path)
