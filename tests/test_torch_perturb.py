"""openeat_torch's speed perturbation and waveform dither against the JAX
package's, on the CPU.

- the offline manifest expansion (dataset_conf.speed_perturb): keys,
  speeds and frame counts equal openeat_tpu/dataset/manifest.py's, and
  np.arange(0.9, 1.1, 0.1) gives the three speeds 0.9, 1.0, 1.1;
- speed_perturb (resample_poly by the speed's fraction of denominator
  at most 100) bit-equal to openeat_tpu/dataset/audio.py's, and
  random_speed's draws from the same generator equal;
- the online collate (speed_perturb_rate 0.5) at one loader worker and
  the same seed: the port's int16 waveform batches equal the JAX
  collate's bit for bit (the same speeds drawn in the same order) over
  two passes of the batches, and differ from an unperturbed collate's;
- the fbank with wav_dither 1.0 and JAX's noise
  (jax.random.normal(key, frames.shape)) handed to the port: within
  3e-4 of JAX's dithered fbank (float32 rounding of the log-mel), and
  far from the undithered one; the training frontend draws its own
  noise of the framed shape from its generator, the same from the same
  seed, and a data-parallel rank's rows of it equal the whole batch's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openeat_tpu.dataset import audio as jax_audio
from openeat_tpu.dataset.dataset import AudioCollate as JaxCollate
from openeat_tpu.dataset.dataset import AudioDataset as JaxDataset
from openeat_tpu.dataset.manifest import parse_manifest as jax_parse
from openeat_tpu.dataset.text import load_dict as jax_load_dict
from openeat_tpu.ops import fbank as jfbank
from openeat_torch.dataset import audio
from openeat_torch.dataset.dataset import (AudioCollate, AudioDataset,
                                           PrefetchLoader)
from openeat_torch.dataset.manifest import parse_manifest
from openeat_torch.dataset.text import load_dict
from openeat_torch.ops import fbank
from openeat_torch.ops.frontend import FrontendConfig, compute_features
from tests.make_tiny_data import build as build_tiny

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return build_tiny(str(tmp_path_factory.mktemp("torch_perturb")),
                      n_utts=6, seed=4, max_dur=1.3)


@pytest.mark.parametrize("speeds", [(0.9, 1.1, 0.1), (0.8, 1.3, 0.2)])
def test_manifest_expansion_equals_jax(data, speeds):
    got = parse_manifest(data["manifest"], load_dict(data["dict"]),
                         speed_perturb=True, speeds=speeds)
    want = jax_parse(data["manifest"], jax_load_dict(data["dict"]),
                     speed_perturb=True, speeds=speeds)
    assert [(u.key, u.speed, u.num_frames, u.token_ids) for u in got] \
        == [(u.key, u.speed, u.num_frames, u.token_ids) for u in want]
    n = len(parse_manifest(data["manifest"], load_dict(data["dict"])))
    if speeds == (0.9, 1.1, 0.1):
        assert sorted({u.speed for u in got}) == pytest.approx(
            [0.9, 1.0, 1.1])
        assert len(got) == 3 * n


@pytest.mark.parametrize("speed", [0.9, 1.0, 1.1, 0.95])
def test_speed_perturb_is_bit_equal(speed):
    x = (np.random.default_rng(1).standard_normal(16000 * 2) * 3000
         ).astype(np.float32)
    got = audio.speed_perturb(x, 16000, speed)
    np.testing.assert_array_equal(got, jax_audio.speed_perturb(x, 16000,
                                                               speed))
    assert abs(len(got) - len(x) / speed) <= 1


def test_random_speed_draws_equal_jax():
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    got = [audio.random_speed((0.9, 1.1, 0.1), a) for _ in range(20)]
    want = [jax_audio.random_speed((0.9, 1.1, 0.1), b) for _ in range(20)]
    assert got == want and len(set(got)) == 3


def test_collate_draws_the_jax_speeds(data):
    ds = AudioDataset(data["manifest"], load_dict(data["dict"]),
                      batch_size=2)
    jds = JaxDataset(data["manifest"], jax_load_dict(data["dict"]),
                     batch_type="static", batch_size=2)
    port = AudioCollate(speed_perturb_rate=0.5, seed=21)
    jax_collate = JaxCollate(speed_perturb_rate=0.5, seed=21,
                             use_native_io=False)
    plain = AudioCollate()
    perturbed = 0
    for _ in range(2):   # one generator over the run, as in JAX
        loader = PrefetchLoader(ds, port, num_workers=1)
        for i, (keys, got) in enumerate(loader):
            jkeys, want = jax_collate(jds[i])
            assert keys == jkeys
            for k in ("wav", "wav_lens", "targets", "targets_length"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            perturbed += not np.array_equal(got["wav_lens"],
                                            plain(ds[i])[1]["wav_lens"])
    assert perturbed > 0


def _wavs(seed=0, b=3, n=8000):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((b, n)) * 2000).astype(np.float32)
    lens = np.array([n, n - 1234, 3000][:b], np.int32)
    for i, m in enumerate(lens):
        wav[i, m:] = 0.0
    return wav, lens


def test_dithered_fbank_with_jax_noise():
    wav, lens = _wavs()
    key = jax.random.PRNGKey(7)
    want, j_lens = jfbank.fbank(jnp.asarray(wav), jnp.asarray(lens),
                                dither=1.0, rng=key)
    t = int(want.shape[1])
    noise = np.array(jax.random.normal(key, (wav.shape[0], t, 400),
                                       jnp.float32))
    got, flens = fbank.fbank(torch.from_numpy(wav), torch.from_numpy(lens),
                             dither=1.0, noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(flens.numpy(), np.asarray(j_lens))
    plain, _ = fbank.fbank(torch.from_numpy(wav), torch.from_numpy(lens))
    want = np.asarray(want)
    for i, n in enumerate(flens.numpy()):
        np.testing.assert_allclose(got[i, :n].numpy(), want[i, :n],
                                   atol=3e-4, rtol=0)
        # the dither moves the features well past that tolerance
        assert float((got[i, :n] - plain[i, :n]).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="noise"):
        fbank.fbank(torch.from_numpy(wav), torch.from_numpy(lens),
                    dither=1.0)
    cfg = FrontendConfig.from_collate_conf(
        {"normalization": False,
         "feature_extraction_conf": {"wav_dither": 1.0}})
    w, n = torch.from_numpy(wav), torch.from_numpy(lens)
    a, b = (compute_features(w, n, cfg, train=True,
                             generator=torch.Generator().manual_seed(5))[0]
            for _ in range(2))
    assert torch.equal(a, b) and not torch.equal(a, got)
    rows, _ = compute_features(w[1:], n[1:], cfg, train=True,
                               generator=torch.Generator().manual_seed(5),
                               batch_lens=n, rows=slice(1, 3))
    assert torch.equal(rows, a[1:])
