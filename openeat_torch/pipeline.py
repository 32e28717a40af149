"""Host -> device feeding with on-device feature extraction (PyTorch).
Port of openeat_tpu/pipeline.py:DeviceFeeder.

Each host batch of padded waveforms (and targets) is copied to the
device and run through the frontend; a batch of precomputed features
(kaldi ark input) goes through the frontend's feature-level tail only
(openeat_torch/ops/frontend.py:augment_features), as the JAX feeder
passes it. In training (train=True) the
frontend's augmentation draws from a generator on the device seeded with
seed + the number of passes already made, as the JAX feeder keys its
PRNG. With accum_grad > 1 every array is reshaped to [accum_grad, micro,
...] for the train step's gradient accumulation, and the features of each
micro-batch are computed in turn.

On a mesh (openeat_torch/parallel/mesh.py) the batch is padded to a
multiple of the node's data ranks (pad_batch_multiple) and only this
rank's rows (of each micro-batch) go to the device, as the JAX feeder
shards the batch axis on 'data': data rank r of d takes rows
[r*B/d, (r+1)*B/d). The augmentation is drawn for the whole batch and
sliced, so a rank's features are the single-process run's rows.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch

from openeat_torch.ops.frontend import (FrontendConfig, augment_features,
                                        compute_features)
from openeat_torch.utils.common import make_generator


def pad_rows(batch: dict, multiple: int) -> dict:
    """Round the batch up to a multiple of rows by repeating rows from
    the first (wrap-around), as the JAX feeder and train_lm's
    shard_batch do."""
    b = next(iter(batch.values())).shape[0]
    target = -(-b // multiple) * multiple
    if target == b:
        return batch
    idx = np.arange(target) % b
    return {k: v[idx] for k, v in batch.items()}


class DeviceFeeder:
    """Wraps a loader yielding (keys, {"wav", "wav_lens"[, "targets",
    "targets_length"]}) into (keys, {"features", "features_length"[,
    "targets", "targets_length"]}) on `device`; on a mesh the arrays
    hold this rank's rows and keys stay the whole batch's.

    pad_batch_multiple (times accum_grad) rounds the batch up by
    repeating utterances (the keys are not padded, so the extra rows are
    never written), which keeps the set of batch shapes small."""

    def __init__(self, loader: Iterable, frontend: FrontendConfig,
                 device: torch.device, pad_batch_multiple: int = 1,
                 train: bool = False, seed: int = 0, accum_grad: int = 1,
                 mesh=None):
        self.loader = loader
        self.mesh = mesh
        self.frontend = frontend
        self.device = device
        self.pad_batch_multiple = max(1, pad_batch_multiple)
        self.train = train
        self.seed = seed
        self.accum_grad = max(1, accum_grad)
        self.epoch = 0

    def __len__(self):
        return len(self.loader)

    def _split_accum(self, batch: dict) -> dict:
        """[accum * micro, ...] -> [accum, micro, ...]."""
        a = self.accum_grad
        return {k: v.reshape((a, v.shape[0] // a) + v.shape[1:])
                for k, v in batch.items()}

    def _micro(self, x: torch.Tensor, lens: torch.Tensor,
                batch_lens: torch.Tensor | None):
        """(x, lens, the whole batch's lens) of each micro-batch in turn:
        one for the batch itself without gradient accumulation."""
        if self.accum_grad == 1:
            return [(x, lens, batch_lens)]
        return [(x[i], lens[i], None if batch_lens is None
                 else batch_lens[i]) for i in range(self.accum_grad)]

    def __iter__(self) -> Iterator[tuple[list, dict]]:
        gen = (make_generator(self.seed + self.epoch, self.device)
               if self.train else None)
        self.epoch += 1
        accum = self.accum_grad > 1
        for keys, batch in self.loader:
            batch = pad_rows(batch, self.pad_batch_multiple
                             * self.accum_grad)
            if accum:
                batch = self._split_accum(batch)
            wav_in = "wav" in batch
            len_key = "wav_lens" if wav_in else "features_length"
            batch_lens, rows = None, slice(None)
            if self.mesh is not None:
                batch_lens = torch.from_numpy(batch[len_key]).to(
                    self.device)
                rows = self.mesh.rows(batch[len_key].shape[-1])
                batch = {k: v[:, rows] if accum else v[rows]
                         for k, v in batch.items()}
            dev = {k: torch.from_numpy(v).to(self.device)
                   for k, v in batch.items()}
            if wav_in:
                parts = [compute_features(w, l, self.frontend, self.train,
                                          gen, bl, rows)
                         for w, l, bl in self._micro(
                             dev["wav"], dev["wav_lens"], batch_lens)]
            else:
                parts = [(augment_features(f, l, self.frontend, self.train,
                                           gen, bl, rows), l)
                         for f, l, bl in self._micro(
                             dev["features"], dev["features_length"],
                             batch_lens)]
            feats, flens = ([torch.stack(x) for x in zip(*parts)] if accum
                            else parts[0])
            out = {"features": feats, "features_length": flens}
            if "targets" in dev:
                out["targets"] = dev["targets"]
                out["targets_length"] = dev["targets_length"]
            yield keys, out
