"""Data pipeline (host): AudioDataset, AudioCollate and a thread-pool
PrefetchLoader. Port of openeat_tpu/dataset/dataset.py for wav input:
manifest -> length-sorted dynamic, static or shuffle batches -> padded
int16 waveform batches with IGNORE_ID-padded targets; the loader can
shuffle the batch order per epoch from a seed. Feature extraction runs
on the device (openeat_torch/ops/frontend.py). Speed perturbation comes
with a later slice."""

from __future__ import annotations

import concurrent.futures as futures
import logging
from typing import Iterator

import numpy as np

from openeat_torch.dataset import audio as audio_lib
from openeat_torch.dataset.batching import make_batches, pad_batch_1d
from openeat_torch.dataset.manifest import (Utterance, parse_manifest,
                                            parse_wav_entry)
from openeat_torch.utils.common import IGNORE_ID

logger = logging.getLogger("openeat_torch")


class AudioDataset:
    """Pre-batched wav dataset: a list of batches (static by default, as
    decoding uses; training passes the config's batch_type)."""

    def __init__(self, data_file: str, char_dict: dict[str, int],
                 max_length: float = 10240, min_length: float = 0,
                 token_max_length: int = 200, token_min_length: int = 0,
                 batch_size: int = 12, sort: bool = True,
                 batch_type: str = "static",
                 max_frames_in_batch: int = 10000, seed: int = 777,
                 speed_perturb: bool = False):
        if speed_perturb:
            raise NotImplementedError(
                "dataset_conf speed_perturb is not ported to openeat_torch "
                "yet; it comes with a later slice (speed perturbation)")
        self.utts = parse_manifest(data_file, char_dict, max_length,
                                   min_length, token_max_length,
                                   token_min_length, sort)
        self.batches = make_batches(self.utts, batch_type, batch_size,
                                    max_frames_in_batch, seed)

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, idx: int) -> list[Utterance]:
        return self.batches[idx]


class AudioCollate:
    """Utterances -> (keys, {"wav": int16 [B, N], "wav_lens": [B],
    "targets": int32 [B, L], "targets_length": [B]}), longest first, N
    padded up to a multiple of `wav_bucket_ms` and L to a multiple of
    `token_bucket` with IGNORE_ID. int16 is exact for PCM sources (the
    x32768 scaling restores the raw samples) and halves the
    host-to-device bytes."""

    def __init__(self, resample_rate: int = 16000, wav_bucket_ms: int = 1000,
                 token_bucket: int = 8):
        self.resample_rate = resample_rate
        self.wav_bucket = int(resample_rate * wav_bucket_ms / 1000)
        self.token_bucket = token_bucket

    def __call__(self, batch: list[Utterance]):
        keys, wavs, tokens = [], [], []
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
            tokens.append(np.asarray(u.token_ids, np.int32))
        if not keys:
            raise RuntimeError("empty batch after error skipping")
        order = np.argsort(-np.asarray([len(w) for w in wavs]))
        wav, wav_lens = pad_batch_1d([wavs[i] for i in order], 0,
                                     self.wav_bucket, np.int16)
        targets, target_lens = pad_batch_1d([tokens[i] for i in order],
                                            IGNORE_ID, self.token_bucket,
                                            np.int32)
        return [keys[i] for i in order], {
            "wav": wav, "wav_lens": wav_lens, "targets": targets,
            "targets_length": target_lens}


class PrefetchLoader:
    """Collates batches on a thread pool, `prefetch` ahead, in order or,
    with shuffle_batches, in an order drawn from seed + the number of
    passes already made (the trainer builds one loader per epoch with
    seed + epoch, as the JAX trainer does)."""

    def __init__(self, dataset, collate, num_workers: int = 4,
                 prefetch: int = 4, shuffle_batches: bool = False,
                 seed: int = 777):
        self.dataset = dataset
        self.collate = collate
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.shuffle_batches = shuffle_batches
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        return len(self.dataset)

    def order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle_batches:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        return order

    def __iter__(self) -> Iterator:
        order = self.order()
        self.epoch += 1
        with futures.ThreadPoolExecutor(self.num_workers) as pool:
            pending = []
            it = iter(order)
            for idx in it:
                pending.append(pool.submit(self.collate,
                                           self.dataset[int(idx)]))
                if len(pending) >= self.prefetch:
                    break
            while pending:
                fut = pending.pop(0)
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.submit(self.collate,
                                               self.dataset[int(nxt)]))
                yield fut.result()
