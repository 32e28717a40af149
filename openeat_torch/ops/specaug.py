"""Feature normalization (PyTorch). Port of the eval part of
openeat_tpu/ops/specaug.py; the random augmentations come with training.
"""

from __future__ import annotations

import torch


def per_utt_normalize(feats: torch.Tensor, feat_lens: torch.Tensor,
                      eps: float = 1e-8) -> torch.Tensor:
    """Per-utterance mean/variance normalization over valid frames.
    feats: [B, T, F]; feat_lens: [B]."""
    t = feats.shape[1]
    valid = (torch.arange(t, device=feats.device)[None, :]
             < feat_lens[:, None])[..., None]
    n = feat_lens.to(feats.dtype).clamp(min=1.0)[:, None, None]
    mean = torch.where(valid, feats, 0.0).sum(dim=1, keepdim=True) / n
    var = torch.where(valid, (feats - mean) ** 2, 0.0).sum(
        dim=1, keepdim=True) / n
    return torch.where(valid, (feats - mean) / torch.sqrt(var + eps), feats)
