"""Host -> device feeding with on-device feature extraction (PyTorch).
Port of openeat_tpu/pipeline.py:DeviceFeeder for one device.

Each host batch of padded waveforms (and targets) is copied to the
device and run through the frontend. In training (train=True) the
frontend's augmentation draws from a generator on the device seeded with
seed + the number of passes already made, as the JAX feeder keys its
PRNG. With accum_grad > 1 every array is reshaped to [accum_grad, micro,
...] for the train step's gradient accumulation, and the features of each
micro-batch are computed in turn.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch

from openeat_torch.ops.frontend import FrontendConfig, compute_features
from openeat_torch.utils.common import make_generator


class DeviceFeeder:
    """Wraps a loader yielding (keys, {"wav", "wav_lens"[, "targets",
    "targets_length"]}) into (keys, {"features", "features_length"[,
    "targets", "targets_length"]}) on `device`.

    pad_batch_multiple (times accum_grad) rounds the batch up by
    repeating utterances (the keys are not padded, so the extra rows are
    never written), which keeps the set of batch shapes small."""

    def __init__(self, loader: Iterable, frontend: FrontendConfig,
                 device: torch.device, pad_batch_multiple: int = 1,
                 train: bool = False, seed: int = 0, accum_grad: int = 1):
        self.loader = loader
        self.frontend = frontend
        self.device = device
        self.pad_batch_multiple = max(1, pad_batch_multiple)
        self.train = train
        self.seed = seed
        self.accum_grad = max(1, accum_grad)
        self.epoch = 0

    def __len__(self):
        return len(self.loader)

    def _pad_batch_dim(self, batch: dict) -> dict:
        m = self.pad_batch_multiple * self.accum_grad
        b = next(iter(batch.values())).shape[0]
        if m <= 1 or b % m == 0:
            return batch
        idx = np.concatenate([np.arange(b), np.arange(m - b % m) % b])
        return {k: v[idx] for k, v in batch.items()}

    def _split_accum(self, batch: dict) -> dict:
        """[accum * micro, ...] -> [accum, micro, ...]."""
        a = self.accum_grad
        return {k: v.reshape((a, v.shape[0] // a) + v.shape[1:])
                for k, v in batch.items()}

    def __iter__(self) -> Iterator[tuple[list, dict]]:
        gen = (make_generator(self.seed + self.epoch, self.device)
               if self.train else None)
        self.epoch += 1
        for keys, batch in self.loader:
            batch = self._pad_batch_dim(batch)
            if self.accum_grad > 1:
                batch = self._split_accum(batch)
            dev = {k: torch.from_numpy(v).to(self.device)
                   for k, v in batch.items()}
            if self.accum_grad > 1:
                parts = [compute_features(w, l, self.frontend, self.train,
                                          gen)
                         for w, l in zip(dev["wav"], dev["wav_lens"])]
                feats = torch.stack([p[0] for p in parts])
                flens = torch.stack([p[1] for p in parts])
            else:
                feats, flens = compute_features(dev["wav"], dev["wav_lens"],
                                                self.frontend, self.train,
                                                gen)
            out = {"features": feats, "features_length": flens}
            if "targets" in dev:
                out["targets"] = dev["targets"]
                out["targets_length"] = dev["targets_length"]
            yield keys, out
