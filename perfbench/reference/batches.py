"""Which utterances a training step sees, worked out from the corpus and
the configuration's dataset_conf, as the recipe defines its batches:

- utterances kept when min_length < frames < max_length (frames = 100 x
  the manifest's duration) and token_min_length < tokens <
  token_max_length, sorted by frames (ties in manifest order);
- dynamic batches: fill a batch until the next utterance would pass
  max_frames_in_batch;
- the updates the check follows (`check_batches`): batches drawn from
  the run's seed, then the batch of the longest utterances (on the
  longest padded T' and S, so CTC runs its cluster kernel K2 there) and
  that of the shortest (the most rows, CTC on K1). The first gradient,
  compared leaf by leaf, is a drawn batch's: on the longest batch's 15
  rows one norm weight's gradient reads up to 0.18 apart in bf16;
- within a batch, rows longest first (numpy argsort of minus the sample
  counts after speed perturbation), waveforms padded with zeros to a
  multiple of 16000 samples, transcripts with -1 to a multiple of 8
  tokens;
- with accum_grad a > 1 the rows wrap around to a multiple of a and
  split in order into a micro-batches.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

WAV_BUCKET = 16000
TOKEN_BUCKET = 8
IGNORE_ID = -1


@dataclass
class MicroBatch:
    rows: list[int]            # pool indices, in row order
    wav_width: int             # padded samples
    token_width: int           # padded tokens


def kept_sorted(samples: np.ndarray, tokens: np.ndarray,
                dataset_conf: dict) -> list[int]:
    frames = [float(s) / 16000 * 1000.0 / 10.0 for s in samples]
    lo, hi = dataset_conf.get("min_length", 0), dataset_conf.get(
        "max_length", 10240)
    tlo = dataset_conf.get("token_min_length", 0)
    thi = dataset_conf.get("token_max_length", 200)
    keep = [i for i in range(len(samples))
            if lo < frames[i] < hi and tlo < tokens[i] < thi]
    return sorted(keep, key=lambda i: frames[i])


def dynamic_batches(order: list[int], samples: np.ndarray,
                    max_frames: int) -> list[list[int]]:
    batches: list[list[int]] = [[]]
    acc = 0.0
    for i in order:
        f = float(samples[i]) / 16000 * 1000.0 / 10.0
        if acc + f > max_frames and batches[-1]:
            batches.append([])
            acc = 0.0
        batches[-1].append(i)
        acc += f
    return [b for b in batches if b]


def check_batches(n_batches: int, seed: int, n: int) -> list[int]:
    """The batch indices of the `n` updates the check follows: n - 2
    drawn from `seed`, then the last (longest utterances) and the first
    (shortest)."""
    if n_batches < n:
        raise ValueError(f"the check follows {n} updates; the epoch has "
                         f"{n_batches} batches")
    rest = np.random.default_rng([int(seed), 5]).permutation(
        np.arange(1, n_batches - 1))
    return [int(b) for b in rest[:n - 2]] + [n_batches - 1, 0]


def _round_up(n: int, m: int) -> int:
    return -(-max(n, 1) // m) * m


def micro_batches(batch: list[int], lens: dict[int, int],
                  tokens: np.ndarray, accum: int) -> list[MicroBatch]:
    """`lens`: each row's samples as the collate reads them (after speed
    perturbation)."""
    lens = np.asarray([int(lens[i]) for i in batch])
    rows = [batch[j] for j in np.argsort(-lens)]
    width = _round_up(int(lens.max()), WAV_BUCKET)
    twidth = _round_up(int(max(tokens[i] for i in batch)), TOKEN_BUCKET)
    if accum > 1:
        target = _round_up(len(rows), accum)
        rows = [rows[j % len(rows)] for j in range(target)]
    micro = len(rows) // accum
    return [MicroBatch(rows[k * micro:(k + 1) * micro], width, twidth)
            for k in range(accum)]


def batches_of(samples: np.ndarray, tokens: np.ndarray,
               dataset_conf: dict) -> list[list[int]]:
    """The epoch's batches (entry indices), in sorted order."""
    return dynamic_batches(kept_sorted(samples, tokens, dataset_conf),
                           samples, dataset_conf["max_frames_in_batch"])
