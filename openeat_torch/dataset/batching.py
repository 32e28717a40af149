"""Batch assembly (host). Port of openeat_tpu/dataset/batching.py for
the static batches decoding uses, with the same shape bucketing."""

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
