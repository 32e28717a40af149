"""Evaluation data pipeline (host): AudioDataset, AudioCollate and a
thread-pool PrefetchLoader. Port of the eval path of
openeat_tpu/dataset/dataset.py: manifest -> length-sorted static batches
-> padded int16 waveform batches. Feature extraction runs on the device
(openeat_torch/ops/frontend.py)."""

from __future__ import annotations

import concurrent.futures as futures
import logging
from typing import Iterator

import numpy as np

from openeat_torch.dataset import audio as audio_lib
from openeat_torch.dataset.batching import make_static_batches, pad_batch_1d
from openeat_torch.dataset.manifest import (Utterance, parse_manifest,
                                            parse_wav_entry)

logger = logging.getLogger("openeat_torch")


class AudioDataset:
    """Pre-batched wav dataset: a list of static batches."""

    def __init__(self, data_file: str, char_dict: dict[str, int],
                 max_length: float = 10240, min_length: float = 0,
                 token_max_length: int = 200, token_min_length: int = 0,
                 batch_size: int = 12, sort: bool = True):
        self.utts = parse_manifest(data_file, char_dict, max_length,
                                   min_length, token_max_length,
                                   token_min_length, sort)
        self.batches = make_static_batches(self.utts, batch_size)

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, idx: int) -> list[Utterance]:
        return self.batches[idx]


class AudioCollate:
    """Utterances -> (keys, {"wav": int16 [B, N], "wav_lens": [B]}),
    longest first, N padded up to a multiple of `wav_bucket_ms`. int16
    is exact for PCM sources (the x32768 scaling restores the raw
    samples) and halves the host-to-device bytes."""

    def __init__(self, resample_rate: int = 16000, wav_bucket_ms: int = 1000):
        self.resample_rate = resample_rate
        self.wav_bucket = int(resample_rate * wav_bucket_ms / 1000)

    def __call__(self, batch: list[Utterance]):
        keys, wavs = [], []
        for u in batch:
            path, start, end = parse_wav_entry(u.path)
            try:
                x, rate = audio_lib.read_wav(path, start, end)
            except (OSError, ValueError) as e:  # skip a corrupt utterance
                logger.warning("read utterance %s error: %s", u.key, e)
                continue
            x = x * 32768.0
            if rate != self.resample_rate:
                x = audio_lib.resample(x, rate, self.resample_rate)
            keys.append(u.key)
            wavs.append(np.clip(np.rint(x), -32768, 32767))
        if not keys:
            raise RuntimeError("empty batch after error skipping")
        order = np.argsort(-np.asarray([len(w) for w in wavs]))
        wav, wav_lens = pad_batch_1d([wavs[i] for i in order], 0,
                                     self.wav_bucket, np.int16)
        return [keys[i] for i in order], {"wav": wav, "wav_lens": wav_lens}


class PrefetchLoader:
    """Collates batches in order on a thread pool, `prefetch` ahead."""

    def __init__(self, dataset, collate, num_workers: int = 4,
                 prefetch: int = 4):
        self.dataset = dataset
        self.collate = collate
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)

    def __len__(self):
        return len(self.dataset)

    def __iter__(self) -> Iterator:
        with futures.ThreadPoolExecutor(self.num_workers) as pool:
            pending = []
            it = iter(range(len(self.dataset)))
            for idx in it:
                pending.append(pool.submit(self.collate, self.dataset[idx]))
                if len(pending) >= self.prefetch:
                    break
            while pending:
                fut = pending.pop(0)
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.submit(self.collate,
                                               self.dataset[nxt]))
                yield fut.result()
