"""Host -> device feeding with on-device feature extraction (PyTorch).
Port of openeat_tpu/pipeline.py:DeviceFeeder for one device and
evaluation."""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch

from openeat_torch.ops.frontend import FrontendConfig, compute_features


class DeviceFeeder:
    """Wraps a loader yielding (keys, {"wav", "wav_lens"}) into
    (keys, {"features", "features_length"}) on `device`.

    pad_batch_multiple rounds the batch up by repeating utterances (the
    keys are not padded, so the extra rows are never written), which
    keeps the set of batch shapes small."""

    def __init__(self, loader: Iterable, frontend: FrontendConfig,
                 device: torch.device, pad_batch_multiple: int = 1):
        self.loader = loader
        self.frontend = frontend
        self.device = device
        self.pad_batch_multiple = max(1, pad_batch_multiple)

    def __len__(self):
        return len(self.loader)

    def _pad_batch_dim(self, batch: dict) -> dict:
        m = self.pad_batch_multiple
        b = next(iter(batch.values())).shape[0]
        if b % m == 0:
            return batch
        idx = np.concatenate([np.arange(b), np.arange(m - b % m) % b])
        return {k: v[idx] for k, v in batch.items()}

    def __iter__(self) -> Iterator[tuple[list, dict]]:
        for keys, batch in self.loader:
            batch = self._pad_batch_dim(batch)
            wav = torch.from_numpy(batch["wav"]).to(self.device)
            wav_lens = torch.from_numpy(batch["wav_lens"]).to(self.device)
            feats, flens = compute_features(wav, wav_lens, self.frontend)
            yield keys, {"features": feats, "features_length": flens}
