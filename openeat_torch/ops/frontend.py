"""Device frontend: waveform batch -> features (PyTorch).

Port of openeat_tpu/ops/frontend.py: fbank, then per-utterance
normalization with padded frames zeroed; in training, then feature
dither, spec-substitute and SpecAugment, drawn from a generator the
caller owns, with padded frames zeroed again. Waveform dither
(``wav_dither``) needs the fbank's dither path and is refused until a
later slice brings it.
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


def augment_features(feats: torch.Tensor, flens: torch.Tensor,
                     cfg: FrontendConfig, train: bool = False,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
    """Feature-level tail, in the JAX order: per-utterance
    normalization, then (train only) dither, spec-sub and SpecAugment,
    padded frames zeroed."""
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
    if cfg.feature_dither:
        feats = specaug.feature_dither(feats, cfg.feature_dither, generator)
    if cfg.spec_sub:
        feats = specaug.spec_substitute(feats, flens, generator,
                                        cfg.spec_sub_max_t, cfg.spec_sub_num)
    if cfg.spec_aug:
        feats = specaug.spec_augment(feats, flens, generator,
                                     cfg.spec_aug_num_t, cfg.spec_aug_num_f,
                                     cfg.spec_aug_max_t, cfg.spec_aug_max_f)
        feats = torch.where(valid, feats, 0.0)
    return feats


def compute_features(wav: torch.Tensor, wav_lens: torch.Tensor,
                     cfg: FrontendConfig, train: bool = False,
                     generator: torch.Generator | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, N] waveforms (x32768 scaled, float32 or int16) -> ([B, T, M]
    features, [B] lengths). With train=False every augmentation of `cfg`
    is skipped, as the JAX frontend does; train=True draws them from
    `generator`."""
    if train and cfg.wav_dither:
        raise NotImplementedError(
            "wav_dither is not ported to openeat_torch yet; it comes with "
            "a later slice (fbank dither path)")
    feats, flens = fbank_mod.fbank(
        wav, wav_lens, sample_rate=cfg.sample_rate,
        num_mel_bins=cfg.num_mel_bins,
        frame_length_ms=cfg.frame_length_ms,
        frame_shift_ms=cfg.frame_shift_ms)
    return augment_features(feats, flens, cfg, train, generator), flens
