"""Data pipeline (host): AudioDataset, AudioCollate, the LM's
TextDataset and TextCollate, and a thread-pool PrefetchLoader. Port of
openeat_tpu/dataset/dataset.py: manifest (text tokenized with the dict
and an optional BPE model) -> length-sorted dynamic, static or shuffle
batches -> padded int16 waveform batches, or padded feature batches for
precomputed kaldi features (data_type "feat"), with IGNORE_ID-padded
targets; the loader can shuffle the batch order per epoch from a seed.
Waveforms are read by the native library (openeat_torch/runtime/
native_io.py: a batch at a time on a C++ thread pool, WAV and FLAC) or,
without it, by the Python decoders, one warning logged. Feature
extraction runs on the device (openeat_torch/ops/frontend.py). Speed
perturbation, as in JAX: offline (dataset_conf.speed_perturb: one
manifest entry per speed) and online (speed_perturb_rate: the collate
re-draws an utterance's speed with that probability)."""

from __future__ import annotations

import concurrent.futures as futures
import logging
from typing import Iterator

import numpy as np

from openeat_torch.dataset import audio as audio_lib
from openeat_torch.dataset import kaldi_io
from openeat_torch.dataset.batching import (make_batches, pad_batch_1d,
                                            pad_batch_2d)
from openeat_torch.dataset.manifest import (Utterance, parse_manifest,
                                            parse_wav_entry)
from openeat_torch.dataset.text import text_to_token_ids
from openeat_torch.runtime import native_io
from openeat_torch.utils.common import IGNORE_ID
from openeat_torch.utils.profiling import span

logger = logging.getLogger("openeat_torch")
IO_THREADS = 8          # the native reader's threads a batch


class AudioDataset:
    """Pre-batched dataset: a list of batches (static by default, as
    decoding uses; training passes the config's batch_type).
    `input_size` is the feature dim of a precomputed-feature manifest,
    else 80."""

    def __init__(self, data_file: str, char_dict: dict[str, int], bpe=None,
                 max_length: float = 10240, min_length: float = 0,
                 token_max_length: int = 200, token_min_length: int = 0,
                 batch_size: int = 12, sort: bool = True,
                 batch_type: str = "static",
                 max_frames_in_batch: int = 10000, seed: int = 777,
                 speed_perturb: bool = False, speeds=(0.9, 1.1, 0.1),
                 data_type: str = "wav"):
        self.utts = parse_manifest(data_file, char_dict, bpe, max_length,
                                   min_length, token_max_length,
                                   token_min_length, speed_perturb, speeds,
                                   data_type, sort)
        self.batches = make_batches(self.utts, batch_type, batch_size,
                                    max_frames_in_batch, seed)
        self.input_size = (self.utts[0].feat_dim
                           if self.utts and self.utts[0].feat_dim else 80)

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
    host-to-device bytes. A batch of precomputed-feature entries gives
    {"features": float32 [B, T, F], "features_length": [B]} in place of
    the waveforms, T padded to a multiple of `frame_bucket`.

    With use_native_io the waveforms of a batch are read by the native
    library (`self.native_io` True; False when it is unavailable: then
    the Python decoders read, and one warning is logged); a file it
    cannot read is skipped like any corrupt utterance.

    After the resample each utterance plays at its manifest entry's
    speed, or, with probability speed_perturb_rate, at a speed drawn
    from `speeds` (lo, hi, step); the collate draws rng.random() for
    every waveform utterance it reads, and then the speed, from one
    np.random.default_rng(seed) over the whole run, in the JAX order.
    The draws follow the order of the calls: at one loader worker the
    batches are collated in order and the speeds are the JAX
    collate's."""

    def __init__(self, resample_rate: int = 16000, wav_bucket_ms: int = 1000,
                 token_bucket: int = 8, speed_perturb_rate: float = 0.0,
                 speeds=(0.9, 1.1, 0.1), seed: int = 777,
                 frame_bucket: int = 100, use_native_io: bool = True):
        self.resample_rate = resample_rate
        self.wav_bucket = int(resample_rate * wav_bucket_ms / 1000)
        self.token_bucket = token_bucket
        self.frame_bucket = frame_bucket
        self.speed_perturb_rate = speed_perturb_rate
        self.speeds = speeds
        self.rng = np.random.default_rng(seed)
        self.native_io = use_native_io and native_io.available()
        if use_native_io and not self.native_io:
            logger.warning("native IO library unavailable (%s); reading "
                           "WAV/FLAC with the Python decoders",
                           native_io.build_error)

    def _read_native(self, batch: list[Utterance]) -> list:
        """The batch's waveforms (x32768, at resample_rate) decoded on the
        native thread pool; None for a file it could not read."""
        entries = [parse_wav_entry(u.path) for u in batch]
        # the manifest's duration, with room to spare, bounds each row
        cap = max(int(max(u.num_frames for u in batch) * self.resample_rate
                      * 0.01 * 1.3) + self.resample_rate, 1)
        wav, lens, rates = native_io.read_wav_batch(
            [e[0] for e in entries], [e[1] for e in entries],
            [e[2] for e in entries], cap, IO_THREADS)
        out = []
        for i in range(len(batch)):
            if lens[i] == 0:
                out.append(None)
                continue
            x = wav[i, : lens[i]] * 32768.0
            if rates[i] != self.resample_rate:
                x = audio_lib.resample(x, int(rates[i]), self.resample_rate)
            out.append(x)
        return out

    def _read_python(self, u: Utterance) -> np.ndarray:
        path, start, end = parse_wav_entry(u.path)
        x, rate = audio_lib.read_audio(path, start, end)
        x = x * 32768.0
        if rate != self.resample_rate:
            x = audio_lib.resample(x, rate, self.resample_rate)
        return x

    def __call__(self, batch: list[Utterance]):
        keys, wavs, feats, tokens = [], [], [], []
        feat_batch = all(u.feat_dim > 0 for u in batch)
        pre = (self._read_native(batch)
               if self.native_io and not feat_batch else None)
        for i, u in enumerate(batch):
            try:
                if u.feat_dim > 0:
                    feats.append(kaldi_io.read_mat(u.path))
                else:
                    if pre is None:
                        x = self._read_python(u)
                    elif pre[i] is None:
                        raise OSError("the native reader could not decode "
                                      f"{u.path}")
                    else:
                        x = pre[i]
                    speed = u.speed
                    if self.rng.random() < self.speed_perturb_rate:
                        speed = audio_lib.random_speed(self.speeds, self.rng)
                    x = audio_lib.speed_perturb(x, self.resample_rate, speed)
                    wavs.append(np.clip(np.rint(x), -32768, 32767))
            except (OSError, ValueError) as e:  # skip a corrupt utterance
                logger.warning("read utterance %s error: %s", u.key, e)
                continue
            keys.append(u.key)
            tokens.append(np.asarray(u.token_ids, np.int32))
        if not keys:
            raise RuntimeError("empty batch after error skipping")
        if wavs and feats:
            raise ValueError("a batch mixes waveform and feature entries")
        lens = [len(w) for w in wavs] or [f.shape[0] for f in feats]
        order = np.argsort(-np.asarray(lens))
        targets, target_lens = pad_batch_1d([tokens[i] for i in order],
                                            IGNORE_ID, self.token_bucket,
                                            np.int32)
        out = {"targets": targets, "targets_length": target_lens}
        if wavs:
            out["wav"], out["wav_lens"] = pad_batch_1d(
                [wavs[i] for i in order], 0, self.wav_bucket, np.int16)
        else:
            out["features"], out["features_length"] = pad_batch_2d(
                [feats[i] for i in order], 0.0, self.frame_bucket,
                np.float32)
        return [keys[i] for i in order], out


class TextDataset:
    """LM dataset: lines of '<utt> <text>' or bare text, tokenized with
    the dict (and an optional BPE model), kept when token_min_length <
    len < token_max_length, sorted by length, cut into batches of
    batch_size rows (int32 arrays)."""

    def __init__(self, data_file: str, char_dict: dict[str, int], bpe=None,
                 token_max_length: int = 200, token_min_length: int = 0,
                 batch_size: int = 32, sort: bool = True):
        rows = []
        with open(data_file, encoding="utf-8") as f:
            for line in f:
                text = line.strip()
                if not text:
                    continue
                parts = text.split(maxsplit=1)
                text = parts[1] if len(parts) == 2 else parts[0]
                ids = text_to_token_ids(text, char_dict, bpe)
                if token_min_length < len(ids) < token_max_length:
                    rows.append(np.asarray(ids, np.int32))
        if sort:
            rows.sort(key=len)
        self.rows = rows
        self.batches = [rows[i: i + batch_size]
                        for i in range(0, len(rows), batch_size)]

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, idx: int) -> list[np.ndarray]:
        return self.batches[idx]


class TextCollate:
    """Rows -> {"tokens": int32 [B, L] IGNORE_ID padded to a multiple of
    token_bucket, "tokens_length": [B]}; for a masked LM
    (autoregressive=False) BERT-style masking from
    np.random.default_rng(seed), drawn in the JAX package's order: per
    token, mask with probability mask_rate; a masked token becomes
    mask_id (80%), a random token (10%) or stays (10%), and only masked
    positions have a target ("masked_targets", IGNORE_ID elsewhere).
    The rng is shared by every call: collate the batches in order for
    masks equal to the JAX package's."""

    def __init__(self, vocab_size: int, autoregressive: bool = True,
                 mask_id: int | None = None, mask_rate: float = 0.15,
                 token_bucket: int = 8, seed: int = 777):
        self.vocab_size = vocab_size
        self.autoregressive = autoregressive
        self.mask_id = vocab_size - 1 if mask_id is None else mask_id
        self.mask_rate = mask_rate
        self.token_bucket = token_bucket
        self.rng = np.random.default_rng(seed)

    def __call__(self, batch: list[np.ndarray]) -> dict:
        tokens, lens = pad_batch_1d(batch, IGNORE_ID, self.token_bucket,
                                    np.int32)
        if self.autoregressive:
            return {"tokens": tokens, "tokens_length": lens}
        inputs = tokens.copy()
        targets = np.full_like(tokens, IGNORE_ID)
        for i, n in enumerate(lens):
            for j in range(int(n)):
                if self.rng.random() < self.mask_rate:
                    targets[i, j] = tokens[i, j]
                    r = self.rng.random()
                    if r < 0.8:
                        inputs[i, j] = self.mask_id
                    elif r < 0.9:
                        inputs[i, j] = int(self.rng.integers(
                            0, self.vocab_size))
        return {"tokens": inputs, "tokens_length": lens,
                "masked_targets": targets}


class PrefetchLoader:
    """Collates batches on a thread pool, `prefetch` ahead, in order or,
    with shuffle_batches, in an order drawn from seed + the number of
    passes already made (the trainer builds one loader per epoch with
    seed + epoch, as the JAX trainer does).

    shard_id / num_shards split the batches between the nodes of a
    --multihost run, as the JAX loader splits them between processes:
    every shard draws the same order, wraps it around to a multiple of
    num_shards, and takes every num_shards-th batch from shard_id, so
    every shard yields the same number of batches.

    The wait for a batch's collate is the span `openeat.loader.wait`
    (utils/profiling.py)."""

    def __init__(self, dataset, collate, num_workers: int = 4,
                 prefetch: int = 4, shuffle_batches: bool = False,
                 seed: int = 777, shard_id: int = 0, num_shards: int = 1):
        self.dataset = dataset
        self.collate = collate
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.shuffle_batches = shuffle_batches
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = max(1, num_shards)
        self.epoch = 0

    def __len__(self):
        return -(-len(self.dataset) // self.num_shards)

    def order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle_batches:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        if self.num_shards > 1:
            order = np.resize(order, len(self) * self.num_shards)
            order = order[self.shard_id::self.num_shards]
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
                with span("openeat.loader.wait"):
                    batch = fut.result()
                yield batch
