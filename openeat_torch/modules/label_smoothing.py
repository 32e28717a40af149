"""Label-smoothing KL loss. Port of
openeat_tpu/modules/label_smoothing.py:label_smoothing_loss.

KL(smoothed one-hot || softmax(logits)) with the off-target mass
smoothing / (V-1), padding positions dropped, normalised by the batch
size or by the valid token count. The entropy term is a constant but is
kept, computed in float32 as the JAX module does, so that the values
match.
"""

from __future__ import annotations

import torch

from openeat_torch.utils.common import IGNORE_ID


def label_smoothing_loss(logits: torch.Tensor, target: torch.Tensor,
                         smoothing: float = 0.1,
                         padding_idx: int = IGNORE_ID,
                         normalize_length: bool = False) -> torch.Tensor:
    """logits: [B, L, V] float32; target: [B, L] with padding_idx pads."""
    b, _, v = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    confidence = 1.0 - smoothing
    off = smoothing / (v - 1)
    valid = target != padding_idx
    tgt = torch.where(valid, target, 0).long()
    onehot_logp = logp.gather(-1, tgt[..., None])[..., 0]
    f32 = dict(dtype=torch.float32, device=logits.device)
    p_ent = (confidence * torch.log(torch.tensor(confidence + 1e-38, **f32))
             + (v - 1) * off * torch.log(torch.tensor(off + 1e-38, **f32)))
    cross = confidence * onehot_logp + off * (logp.sum(dim=-1) - onehot_logp)
    kl = torch.where(valid, p_ent - cross, 0.0)
    denom = valid.sum().clamp(min=1) if normalize_length else b
    return kl.sum() / denom
