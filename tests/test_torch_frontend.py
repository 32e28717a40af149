"""openeat_torch frontend parity on the CPU: kaldi fbank against the JAX
fbank and the float64 numpy oracle, and the eval-mode compute_features
against the JAX one, on int16 and float32 waveforms.

Tolerance: 3e-4 max abs log-mel error everywhere. The port computes the
framed-matmul path in float32, whose rounding alone moves a log-mel
value by up to ~2e-4 on these signals: the JAX package's own framed
path is 1.7e-4 from the float64 oracle here, and its docstring quotes
7.8e-5 on real speech (openeat_tpu/ops/fbank.py:118-122).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openeat_tpu.ops import fbank as jfbank
from openeat_tpu.ops.frontend import FrontendConfig as JaxFrontendConfig
from openeat_tpu.ops.frontend import compute_features as jax_features
from openeat_torch.ops import fbank
from openeat_torch.ops.frontend import FrontendConfig, compute_features

torch.set_num_threads(1)


def _wavs(seed=0):
    """Two int16-valued utterances (sine + noise), ragged, zero padded."""
    rng = np.random.default_rng(seed)
    lens = np.array([16000, 11123], np.int32)
    wav = np.zeros((2, 16000), np.int16)
    for i, n in enumerate(lens):
        t = np.arange(n) / 16000.0
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 2000) * t) \
            + 0.05 * rng.standard_normal(n)
        wav[i, :n] = np.clip(np.rint(x * 32768), -32768, 32767)
    return wav, lens


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_fbank_matches_jax_and_oracle(dtype):
    wav, lens = _wavs()
    feats, flens = fbank.fbank(torch.from_numpy(wav.astype(dtype)),
                               torch.from_numpy(lens))
    assert feats.dtype == torch.float32
    j_mm, j_lens = jfbank.fbank(jnp.asarray(wav.astype(np.float32)),
                                jnp.asarray(lens), fft_impl="matmul")
    j_auto, _ = jfbank.fbank(jnp.asarray(wav.astype(np.float32)),
                             jnp.asarray(lens))
    np.testing.assert_array_equal(flens.numpy(), np.asarray(j_lens))
    for i, n in enumerate(flens.numpy()):
        got = feats[i, :n].numpy()
        np.testing.assert_allclose(got, np.asarray(j_mm)[i, :n], atol=3e-4,
                                   rtol=0)
        np.testing.assert_allclose(got, np.asarray(j_auto)[i, :n],
                                   atol=3e-4, rtol=0)
        oracle = jfbank.fbank_numpy_reference(
            wav[i, :lens[i]].astype(np.float64))
        np.testing.assert_allclose(got, oracle, atol=3e-4, rtol=0)


def test_numpy_tables_are_the_jax_tables():
    np.testing.assert_array_equal(fbank.mel_banks(80, 512, 16000.0),
                                  jfbank.mel_banks(80, 512, 16000.0))
    np.testing.assert_array_equal(fbank.dft_basis(400, 512),
                                  jfbank.dft_basis(400, 512))


def test_compute_features_eval_matches_jax():
    wav, lens = _wavs(1)
    cfg = FrontendConfig.from_collate_conf(
        {"spec_aug": True, "feature_extraction_conf": {"wav_dither": 1.0}})
    # training dithers the framed samples (and needs a generator)
    with pytest.raises(ValueError, match="generator"):
        compute_features(torch.from_numpy(wav), torch.from_numpy(lens), cfg,
                         train=True)
    feats, flens = compute_features(torch.from_numpy(wav),
                                    torch.from_numpy(lens),
                                    cfg.without_augmentation())
    # evaluation skips every augmentation of the config, as JAX does
    eval_feats, _ = compute_features(torch.from_numpy(wav),
                                     torch.from_numpy(lens), cfg)
    assert torch.equal(eval_feats, feats)
    dithered, _ = compute_features(
        torch.from_numpy(wav), torch.from_numpy(lens),
        FrontendConfig.from_collate_conf(
            {"feature_extraction_conf": {"wav_dither": 1.0}}),
        train=True, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(dithered, feats)
    jcfg = JaxFrontendConfig.from_collate_conf(
        {"spec_aug": True}).without_augmentation()
    j_feats, j_lens = jax_features(jnp.asarray(wav), jnp.asarray(lens),
                                   jax.random.PRNGKey(0), jcfg, train=False)
    np.testing.assert_array_equal(flens.numpy(), np.asarray(j_lens))
    # per-utterance normalization divides by the feature std (~1-3 here),
    # which keeps the log-mel error scale
    np.testing.assert_allclose(feats.numpy(), np.asarray(j_feats),
                               atol=3e-4, rtol=0)
    assert (feats[1, int(flens[1]):] == 0).all()
