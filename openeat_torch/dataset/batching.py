"""Batch assembly (host). Port of openeat_tpu/dataset/batching.py:
dynamic (frame budget), static and shuffle batches over length-sorted
utterances, with the same shape bucketing."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from openeat_torch.dataset.manifest import Utterance


def make_static_batches(utts: Sequence[Utterance],
                        batch_size: int) -> list[list[Utterance]]:
    """Fixed-size batches over the (length-sorted) utterances."""
    utts = list(utts)
    return [utts[i: i + batch_size] for i in range(0, len(utts), batch_size)]


def make_batches(utts: Sequence[Utterance], batch_type: str = "dynamic",
                 batch_size: int = 12, max_frames_in_batch: int = 10000,
                 seed: int = 777) -> list[list[Utterance]]:
    """dynamic: fill a batch until adding the next utterance would pass
    max_frames_in_batch frames; static: batch_size utterances; shuffle:
    static over a seeded permutation."""
    if batch_type not in ("static", "dynamic", "shuffle"):
        raise ValueError(f"batch_type {batch_type!r}; have static, dynamic, "
                         "shuffle")
    utts = list(utts)
    if batch_type == "dynamic":
        if max_frames_in_batch <= 0:
            raise ValueError("dynamic batches need max_frames_in_batch > 0")
        batches: list[list[Utterance]] = [[]]
        acc = 0.0
        for u in utts:
            if acc + u.num_frames > max_frames_in_batch and batches[-1]:
                batches.append([])
                acc = 0.0
            batches[-1].append(u)
            acc += u.num_frames
        return [b for b in batches if b]
    if batch_type == "shuffle":
        order = np.random.default_rng(seed).permutation(len(utts))
        utts = [utts[i] for i in order]
    return make_static_batches(utts, batch_size)


def round_up(n: int, multiple: int) -> int:
    return int(math.ceil(max(n, 1) / multiple) * multiple)


def pad_batch_1d(arrays: list[np.ndarray], pad_value,
                 bucket: int, dtype) -> tuple[np.ndarray, np.ndarray]:
    """Stack variable-length 1-D arrays into [B, round_up(maxlen, bucket)]."""
    lens = np.array([len(a) for a in arrays], np.int32)
    width = round_up(int(lens.max()), bucket)
    out = np.full((len(arrays), width), pad_value, dtype)
    for i, a in enumerate(arrays):
        out[i, : len(a)] = a
    return out, lens
