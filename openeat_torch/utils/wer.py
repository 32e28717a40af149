"""WER/CER scoring with edit-distance alignment. A copy of
openeat_tpu/utils/wer.py, which imports no JAX, kept here so that the
port needs nothing of the JAX package: Levenshtein alignment of
hypothesis and reference tokens, substitution/insertion/deletion counts,
char (CER, CJK-aware splitting) or word mode, case folding, and corpus
aggregation with an optional per-utterance alignment printout.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

CJK_RE = re.compile(r"([一-鿿])")


def characterize(text: str, case_sensitive: bool = False) -> list[str]:
    """CER tokenization: each CJK char is a unit, non-CJK splits on
    whitespace (so English words stay whole, like the reference's
    Mandarin/English cluster handling)."""
    if not case_sensitive:
        text = text.upper()
    units: list[str] = []
    for span in CJK_RE.split(text):
        if not span.strip():
            continue
        if CJK_RE.fullmatch(span):
            units.append(span)
        else:
            units.extend(span.split())
    return units


def wordize(text: str, case_sensitive: bool = False) -> list[str]:
    if not case_sensitive:
        text = text.upper()
    return text.split()


@dataclass
class EditStats:
    sub: int = 0
    ins: int = 0
    dele: int = 0
    cor: int = 0
    ref_len: int = 0
    alignment: list = field(default_factory=list)

    @property
    def errors(self) -> int:
        return self.sub + self.ins + self.dele

    @property
    def wer(self) -> float:
        return 100.0 * self.errors / max(self.ref_len, 1)


def align(ref: list[str], hyp: list[str]) -> EditStats:
    """Levenshtein DP with backtrace (sub cost 1, ins/del cost 1)."""
    n, m = len(ref), len(hyp)
    dp = [[0] * (m + 1) for _ in range(n + 1)]
    bt = [[0] * (m + 1) for _ in range(n + 1)]  # 0 diag, 1 up(del), 2 left(ins)
    for i in range(1, n + 1):
        dp[i][0] = i
        bt[i][0] = 1
    for j in range(1, m + 1):
        dp[0][j] = j
        bt[0][j] = 2
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            c_diag = dp[i - 1][j - 1] + (ref[i - 1] != hyp[j - 1])
            c_del = dp[i - 1][j] + 1
            c_ins = dp[i][j - 1] + 1
            best = min(c_diag, c_del, c_ins)
            dp[i][j] = best
            bt[i][j] = 0 if best == c_diag else (1 if best == c_del else 2)
    stats = EditStats(ref_len=n)
    i, j = n, m
    pairs = []
    while i > 0 or j > 0:
        move = bt[i][j]
        if move == 0 and i > 0 and j > 0:
            if ref[i - 1] == hyp[j - 1]:
                stats.cor += 1
                pairs.append((ref[i - 1], hyp[j - 1], "C"))
            else:
                stats.sub += 1
                pairs.append((ref[i - 1], hyp[j - 1], "S"))
            i, j = i - 1, j - 1
        elif move == 1 and i > 0:
            stats.dele += 1
            pairs.append((ref[i - 1], "*", "D"))
            i -= 1
        else:
            stats.ins += 1
            pairs.append(("*", hyp[j - 1], "I"))
            j -= 1
    stats.alignment = pairs[::-1]
    return stats


def corpus_wer(refs: dict[str, str], hyps: dict[str, str],
               char_mode: bool = True, case_sensitive: bool = False,
               verbose_file=None, clusters: bool = False):
    """Aggregate WER/CER over utterances keyed by id
    (reference compute-wer.py main loop).

    clusters=True additionally returns per-cluster Mandarin/English
    stats (reference compute-wer.py:198-251: error breakdown by token
    script): returns (total, {"Mandarin": EditStats, "English": ...}).
    """
    total = EditStats()
    per = {"Mandarin": EditStats(), "English": EditStats()}
    tok = characterize if char_mode else wordize
    for key, ref_text in refs.items():
        hyp_text = hyps.get(key, "")
        s = align(tok(ref_text, case_sensitive), tok(hyp_text,
                                                     case_sensitive))
        total.sub += s.sub
        total.ins += s.ins
        total.dele += s.dele
        total.cor += s.cor
        total.ref_len += s.ref_len
        if clusters:
            for r, h, op in s.alignment:
                unit = r if r != "*" else h
                c = per["Mandarin" if CJK_RE.fullmatch(unit)
                        else "English"]
                if op == "C":
                    c.cor += 1
                elif op == "S":
                    c.sub += 1
                elif op == "D":
                    c.dele += 1
                else:
                    c.ins += 1
                if r != "*":
                    c.ref_len += 1
        if verbose_file is not None:
            verbose_file.write(
                f"utt: {key}\nWER: {s.wer:.2f} % N={s.ref_len} "
                f"C={s.cor} S={s.sub} D={s.dele} I={s.ins}\n"
                "ref: " + " ".join(r for r, _, _ in s.alignment) + "\n"
                "hyp: " + " ".join(h for _, h, _ in s.alignment) + "\n\n")
    if clusters:
        return total, per
    return total
