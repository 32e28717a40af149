"""Feature augmentation and normalization (PyTorch). Port of
openeat_tpu/ops/specaug.py: per-utterance normalization, feature dither,
spec-substitute and SpecAugment, batched over padded utterances with the
random spans drawn against each utterance's own length.

Each augmentation is split into drawing its random spans (from a
``torch.Generator`` on the features' device) and applying given spans,
so that a test can hand the port the spans that JAX drew.
"""

from __future__ import annotations

import torch

SPEC_MASK_VALUE = 0.0


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


def draw_feature_dither(shape, max_dither: float, generator: torch.Generator,
                        device) -> torch.Tensor:
    """Noise U(-a/2, a/2) with one amplitude a ~ U(0, max_dither) per
    batch (reference dataset.py:199-201)."""
    a = torch.rand((), generator=generator, device=device) * max_dither
    return (torch.rand(shape, generator=generator, device=device) - 0.5) * a


def feature_dither(feats: torch.Tensor, max_dither: float,
                   generator: torch.Generator) -> torch.Tensor:
    return feats + draw_feature_dither(feats.shape, max_dither, generator,
                                       feats.device)


def _rand_span(upper: torch.Tensor, max_len: int, shape: tuple,
               generator: torch.Generator
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """start ~ U[0, upper-1] (as floor(u * upper)), length ~ U[1, max_len]."""
    u = torch.rand(shape, generator=generator, device=upper.device)
    start = (u * upper.clamp(min=1).float()).long()
    length = torch.randint(1, max_len + 1, shape, generator=generator,
                           device=upper.device)
    return start, length


def draw_spec_augment(feat_lens: torch.Tensor, num_freq: int,
                      generator: torch.Generator, num_t_mask: int = 2,
                      num_f_mask: int = 2, max_t: int = 50, max_f: int = 10):
    """Spans for :func:`apply_spec_augment`: time starts/lengths [B,
    num_t_mask] over each utterance's frames, frequency starts/lengths
    [B, num_f_mask] over the num_freq bins."""
    b = feat_lens.shape[0]
    ts, tl = _rand_span(feat_lens[:, None], max_t, (b, num_t_mask), generator)
    fs, fl = _rand_span(torch.full((b, 1), num_freq, device=feat_lens.device),
                        max_f, (b, num_f_mask), generator)
    return ts, tl, fs, fl


def apply_spec_augment(feats: torch.Tensor, ts, tl, fs, fl) -> torch.Tensor:
    """Zero the time spans [ts, ts+tl) and frequency spans [fs, fs+fl)."""
    _, t, f = feats.shape
    pos_t = torch.arange(t, device=feats.device)[None, None, :]
    t_masked = ((pos_t >= ts[..., None])
                & (pos_t < (ts + tl)[..., None])).any(dim=1)     # [B, T]
    pos_f = torch.arange(f, device=feats.device)[None, None, :]
    f_masked = ((pos_f >= fs[..., None])
                & (pos_f < (fs + fl)[..., None])).any(dim=1)     # [B, F]
    masked = t_masked[:, :, None] | f_masked[:, None, :]
    return torch.where(masked, SPEC_MASK_VALUE, feats)


def spec_augment(feats: torch.Tensor, feat_lens: torch.Tensor,
                 generator: torch.Generator, num_t_mask: int = 2,
                 num_f_mask: int = 2, max_t: int = 50,
                 max_f: int = 10) -> torch.Tensor:
    """SpecAugment time and frequency zero-masks, batched."""
    spans = draw_spec_augment(feat_lens, feats.shape[2], generator,
                              num_t_mask, num_f_mask, max_t, max_f)
    return apply_spec_augment(feats, *spans)


def draw_spec_substitute(feat_lens: torch.Tensor, generator: torch.Generator,
                         max_t: int = 20, num_t_sub: int = 3):
    """(start, length, pos), each [num_t_sub, B]: start ~ U[0, len-1],
    length ~ U[1, max_t], pos ~ U[0, start]."""
    b = feat_lens.shape[0]
    dev = feat_lens.device
    starts, lengths, poss = [], [], []
    for _ in range(num_t_sub):
        u = torch.rand((b,), generator=generator, device=dev)
        start = (u * feat_lens.clamp(min=1).float()).long()
        length = torch.randint(1, max_t + 1, (b,), generator=generator,
                               device=dev)
        pos = (torch.rand((b,), generator=generator, device=dev)
               * (start + 1).float()).long()
        starts.append(start)
        lengths.append(length)
        poss.append(pos)
    return torch.stack(starts), torch.stack(lengths), torch.stack(poss)


def apply_spec_substitute(feats: torch.Tensor, start, length,
                          pos) -> torch.Tensor:
    """For each substitute in order: y[start:start+len] =
    y[start-pos:start+len-pos] (sources clipped to [0, T-1])."""
    _, t, f = feats.shape
    idx = torch.arange(t, device=feats.device)[None, :]
    y = feats
    for st, ln, ps in zip(start, length, pos):
        in_span = (idx >= st[:, None]) & (idx < (st + ln)[:, None])
        src = torch.where(in_span, idx - ps[:, None], idx).clamp(0, t - 1)
        y = y.gather(1, src[..., None].expand(-1, -1, f))
    return y


def spec_substitute(feats: torch.Tensor, feat_lens: torch.Tensor,
                    generator: torch.Generator, max_t: int = 20,
                    num_t_sub: int = 3) -> torch.Tensor:
    """Copy an earlier time span over a later one, num_t_sub times."""
    return apply_spec_substitute(
        feats, *draw_spec_substitute(feat_lens, generator, max_t, num_t_sub))
