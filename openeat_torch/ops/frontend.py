"""Device frontend: waveform batch -> features (PyTorch).

Port of openeat_tpu/ops/frontend.py: fbank (in training with waveform
dither, ``wav_dither``: noise on the framed samples), then
per-utterance normalization with padded frames zeroed; in training,
then feature dither, spec-substitute and SpecAugment, all drawn from a
generator the caller owns, with padded frames zeroed again.

A data-parallel rank computes the features of its rows only (`rows` of
a batch whose lengths are `batch_lens`) but draws the augmentation for
the whole batch and keeps its rows' draws, so that its rows equal the
single-process run's rows of that batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from openeat_torch.ops import fbank as fbank_mod
from openeat_torch.ops import specaug


@dataclass(frozen=True)
class FrontendConfig:
    """Mirrors collate_conf (examples/aishell/conf/train.yaml)."""

    sample_rate: int = 16000
    num_mel_bins: int = 80
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    wav_dither: float = 0.0
    normalization: bool = True
    feature_dither: float = 0.0
    spec_sub: bool = False
    spec_sub_max_t: int = 30
    spec_sub_num: int = 3
    spec_aug: bool = False
    spec_aug_num_t: int = 2
    spec_aug_num_f: int = 2
    spec_aug_max_t: int = 50
    spec_aug_max_f: int = 10

    @classmethod
    def from_collate_conf(cls, conf: dict) -> "FrontendConfig":
        fe = conf.get("feature_extraction_conf", {}) or {}
        sa = conf.get("spec_aug_conf", {}) or {}
        ss = conf.get("spec_sub_conf", {}) or {}
        return cls(
            sample_rate=fe.get("resample_rate", 16000),
            num_mel_bins=fe.get("mel_bins", 80),
            wav_dither=fe.get("wav_dither", 0.0),
            normalization=conf.get("normalization", True),
            feature_dither=conf.get("feature_dither", 0.0),
            spec_sub=conf.get("spec_sub", False),
            spec_sub_max_t=ss.get("max_t", 30),
            spec_sub_num=ss.get("num_t_sub", 3),
            spec_aug=conf.get("spec_aug", False),
            spec_aug_num_t=sa.get("num_t_mask", 2),
            spec_aug_num_f=sa.get("num_f_mask", 2),
            spec_aug_max_t=sa.get("max_t", 50),
            spec_aug_max_f=sa.get("max_f", 10),
        )

    def without_augmentation(self) -> "FrontendConfig":
        """Test-time copy with all randomness stripped."""
        return FrontendConfig(
            sample_rate=self.sample_rate, num_mel_bins=self.num_mel_bins,
            frame_length_ms=self.frame_length_ms,
            frame_shift_ms=self.frame_shift_ms,
            normalization=self.normalization)


def feature_lengths(wav_lens: torch.Tensor,
                    cfg: FrontendConfig) -> torch.Tensor:
    """The fbank frame count of each waveform length."""
    return fbank_mod.num_frames(
        wav_lens, int(cfg.sample_rate * cfg.frame_length_ms / 1000.0),
        int(cfg.sample_rate * cfg.frame_shift_ms / 1000.0))


def augment_features(feats: torch.Tensor, flens: torch.Tensor,
                     cfg: FrontendConfig, train: bool = False,
                     generator: torch.Generator | None = None,
                     batch_flens: torch.Tensor | None = None,
                     rows: slice = slice(None)) -> torch.Tensor:
    """Feature-level tail, in the JAX order: per-utterance
    normalization, then (train only) dither, spec-sub and SpecAugment,
    padded frames zeroed. feats are `rows` of a batch with frame counts
    `batch_flens` (default: feats is the whole batch)."""
    t = feats.shape[1]
    valid = (torch.arange(t, device=feats.device)[None, :]
             < flens[:, None])[..., None]
    feats = torch.where(valid, feats, 0.0)
    if cfg.normalization:
        feats = torch.where(valid, specaug.per_utt_normalize(feats, flens),
                            0.0)
    if not train:
        return feats
    if generator is None:
        raise ValueError("training-time augmentation needs a generator")
    lens = flens if batch_flens is None else batch_flens
    if cfg.feature_dither:
        feats = feats + specaug.draw_feature_dither(
            (lens.shape[0],) + feats.shape[1:], cfg.feature_dither,
            generator, feats.device)[rows]
    if cfg.spec_sub:
        spans = specaug.draw_spec_substitute(lens, generator,
                                             cfg.spec_sub_max_t,
                                             cfg.spec_sub_num)
        feats = specaug.apply_spec_substitute(
            feats, *(x[:, rows] for x in spans))
    if cfg.spec_aug:
        spans = specaug.draw_spec_augment(
            lens, feats.shape[2], generator, cfg.spec_aug_num_t,
            cfg.spec_aug_num_f, cfg.spec_aug_max_t, cfg.spec_aug_max_f)
        feats = specaug.apply_spec_augment(feats,
                                           *(x[rows] for x in spans))
        feats = torch.where(valid, feats, 0.0)
    return feats


def compute_features(wav: torch.Tensor, wav_lens: torch.Tensor,
                     cfg: FrontendConfig, train: bool = False,
                     generator: torch.Generator | None = None,
                     batch_lens: torch.Tensor | None = None,
                     rows: slice = slice(None)
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, N] waveforms (x32768 scaled, float32 or int16) -> ([B, T, M]
    features, [B] lengths). With train=False every augmentation of `cfg`
    is skipped, as the JAX frontend does; train=True draws them from
    `generator`, for the whole batch of waveform lengths `batch_lens`
    whose `rows` wav holds (default: wav is the whole batch)."""
    dither, noise = (cfg.wav_dither if train else 0.0), None
    if dither:
        if generator is None:
            raise ValueError("training-time augmentation needs a generator")
        # the whole batch's noise, this rank's rows kept
        frame_len = int(cfg.sample_rate * cfg.frame_length_ms / 1000.0)
        t = fbank_mod.num_frames(wav.shape[1], frame_len, int(
            cfg.sample_rate * cfg.frame_shift_ms / 1000.0))
        b = wav.shape[0] if batch_lens is None else batch_lens.shape[0]
        noise = torch.randn((b, t, frame_len), generator=generator,
                            device=wav.device)[rows]
    feats, flens = fbank_mod.fbank(
        wav, wav_lens, sample_rate=cfg.sample_rate,
        num_mel_bins=cfg.num_mel_bins,
        frame_length_ms=cfg.frame_length_ms,
        frame_shift_ms=cfg.frame_shift_ms, dither=dither, noise=noise)
    batch_flens = (None if batch_lens is None
                   else feature_lengths(batch_lens, cfg))
    return augment_features(feats, flens, cfg, train, generator,
                            batch_flens, rows), flens
