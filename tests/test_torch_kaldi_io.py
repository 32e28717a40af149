"""Kaldi ark input on the port against the JAX package.

Matrices from seeded numpy. Arks written by the JAX package's writers
(FM; CM, kaldi's compression format 1) and a CM2 entry assembled here
read back equal (exactly: both readers compute the same float64 formula
and round once) through the port's read_mat; the port's writers write
the JAX writers' bytes; a `feat_shape: frames,dim` manifest parses as
JAX's does; the collate's feature batch equals JAX's; the feeder's
feature path (normalization only, in eval) equals JAX's augment_features
within 1e-5.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openeat_tpu.dataset import kaldi_io as jax_kaldi
from openeat_tpu.dataset.dataset import AudioCollate as JaxCollate
from openeat_tpu.dataset.dataset import AudioDataset as JaxDataset
from openeat_tpu.ops.frontend import FrontendConfig as JaxFrontendConfig
from openeat_tpu.ops.frontend import augment_features as jax_augment
from openeat_torch.dataset import kaldi_io
from openeat_torch.dataset.dataset import (AudioCollate, AudioDataset,
                                           PrefetchLoader)
from openeat_torch.ops.frontend import FrontendConfig, compute_features
from openeat_torch.pipeline import DeviceFeeder

DICT = {"<blank>": 0, "<unk>": 1, "A": 2, "B": 3, "C": 4, "<sos/eos>": 5}


def write_feature_corpus(path_prefix: str, mats: list, writer) -> str:
    """An ark of `mats` written with `writer` (write_ark_entry or
    write_compressed_ark_entry) and its `feat_shape: frames,dim`
    manifest; returns the manifest's path."""
    ark = path_prefix + ".ark"
    lines = []
    with open(ark, "wb") as f:
        for i, m in enumerate(mats):
            off = writer(f, f"u{i}", m)
            lines.append(f"utt:u{i}\tfeat:{ark}:{off}\t"
                         f"feat_shape:{m.shape[0]},{m.shape[1]}\t"
                         f"text:{'ABC'[i % 3] * (1 + i % 4)}\n")
    manifest = path_prefix + ".data"
    with open(manifest, "w", encoding="utf-8") as f:
        f.writelines(lines)
    return manifest


def fbank_ark_manifest(manifest: str, char_dict: dict, prefix: str,
                       compressed: bool = False) -> tuple[str, dict]:
    """The raw fbank (the port's frontend, no normalization) of every
    utterance of a wav manifest, as an FM (or CM) ark and a `feat_shape:
    frames,dim` manifest with the same text; returns (manifest, {key:
    features})."""
    ds = AudioDataset(manifest, char_dict, batch_size=4, max_length=1e9)
    fe = FrontendConfig(normalization=False)
    texts = {}
    for line in open(manifest, encoding="utf-8"):
        fields = dict(kv.split(":", 1)
                      for kv in line.rstrip("\n").split("\t"))
        texts[fields["utt"]] = fields["text"]
    feats = {}
    for batch in ds.batches:
        keys, host = AudioCollate()(batch)
        f, lens = compute_features(torch.from_numpy(host["wav"]),
                                   torch.from_numpy(host["wav_lens"]), fe)
        for i, k in enumerate(keys):
            feats[k] = f[i, : int(lens[i])].numpy()
    writer = (kaldi_io.write_compressed_ark_entry if compressed
              else kaldi_io.write_ark_entry)
    ark, lines = prefix + ".ark", []
    with open(ark, "wb") as f:
        for k, m in feats.items():
            off = writer(f, k, m)
            lines.append(f"utt:{k}\tfeat:{ark}:{off}\tfeat_shape:"
                         f"{m.shape[0]},{m.shape[1]}\ttext:{texts[k]}\n")
    with open(prefix + ".data", "w", encoding="utf-8") as f:
        f.writelines(lines)
    return prefix + ".data", feats


def _mats(rng, n=5, dim=80):
    return [(rng.standard_normal((int(rng.integers(40, 130)), dim)) * 3.0
             + 2.0).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("kind", ["FM", "CM"])
def test_jax_written_arks_read_equal(tmp_path, rng, kind):
    mats = _mats(rng)
    jwriter = (jax_kaldi.write_ark_entry if kind == "FM"
               else jax_kaldi.write_compressed_ark_entry)
    pwriter = (kaldi_io.write_ark_entry if kind == "FM"
               else kaldi_io.write_compressed_ark_entry)
    jm = write_feature_corpus(str(tmp_path / "jax"), mats, jwriter)
    pm = write_feature_corpus(str(tmp_path / "port"), mats, pwriter)
    assert (tmp_path / "jax.ark").read_bytes() \
        == (tmp_path / "port.ark").read_bytes()
    for line in open(jm, encoding="utf-8"):
        entry = line.split("\t")[1].split(":", 1)[1]
        got = kaldi_io.read_mat(entry)
        np.testing.assert_array_equal(got, jax_kaldi.read_mat(entry))
        assert got.dtype == np.float32
    got = [kaldi_io.read_mat(line.split("\t")[1].split(":", 1)[1])
           for line in open(pm, encoding="utf-8")]
    if kind == "FM":
        for g, m in zip(got, mats):
            np.testing.assert_array_equal(g, m)
    else:   # 8-bit codes between per-column percentiles
        for g, m in zip(got, mats):
            assert np.abs(g - m).max() < 0.05 * (m.max() - m.min())


def test_cm2_and_dm_read_equal(tmp_path, rng):
    rows, cols, lo, span = 7, 5, -1.25, 6.5
    u = rng.integers(0, 65536, rows * cols).astype("<u2")
    dm = rng.standard_normal((4, 3))
    path = tmp_path / "x.ark"
    with open(path, "wb") as f:
        f.write(b"a ")
        off_cm2 = f.tell()
        f.write(b"\x00BCM2 " + struct.pack("<ffii", lo, span, rows, cols)
                + u.tobytes())
        f.write(b"b ")
        off_dm = f.tell()
        f.write(b"\x00BDM \x04" + struct.pack("<i", 4) + b"\x04"
                + struct.pack("<i", 3) + dm.astype("<f8").tobytes())
    for off in (off_cm2, off_dm):
        entry = f"{path}:{off}"
        np.testing.assert_array_equal(kaldi_io.read_mat(entry),
                                      jax_kaldi.read_mat(entry))
    want = (lo + span * (u.astype(np.float64) / 65535.0)).reshape(rows, cols)
    np.testing.assert_allclose(kaldi_io.read_mat(f"{path}:{off_cm2}"), want,
                               rtol=1e-6)
    with pytest.raises(ValueError, match="binary"):
        kaldi_io.read_mat(f"{path}:0")


def test_feature_manifest_and_collate_equal_jax(tmp_path, rng):
    manifest = write_feature_corpus(str(tmp_path / "f"), _mats(rng),
                                    kaldi_io.write_ark_entry)
    kw = dict(batch_type="static", batch_size=5, data_type="feat")
    ds = AudioDataset(manifest, DICT, **kw)
    jds = JaxDataset(manifest, DICT, **kw)
    assert ds.input_size == jds.input_size == 80
    assert [(u.key, u.path, u.num_frames, u.feat_dim, u.token_ids)
            for u in ds.utts] == [(u.key, u.path, u.num_frames, u.feat_dim,
                                   u.token_ids) for u in jds.utts]
    keys, got = AudioCollate()(ds[0])
    jkeys, want = JaxCollate(use_native_io=False)(jds[0])
    assert keys == jkeys and set(got) == set(want) == {
        "features", "features_length", "targets", "targets_length"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["features"].shape[1] % 100 == 0


def test_feeder_feature_path_equals_jax(tmp_path, rng):
    manifest = write_feature_corpus(str(tmp_path / "f"), _mats(rng),
                                    kaldi_io.write_ark_entry)
    ds = AudioDataset(manifest, DICT, batch_size=5, data_type="feat")
    fe = FrontendConfig.from_collate_conf({"spec_aug": True})
    feeder = DeviceFeeder(PrefetchLoader(ds, AudioCollate()),
                          fe.without_augmentation(), torch.device("cpu"))
    (keys, batch), = list(feeder)
    _, host = AudioCollate()(ds[0])
    want = jax_augment(jnp.asarray(host["features"]),
                       jnp.asarray(host["features_length"]),
                       jax.random.PRNGKey(0),
                       JaxFrontendConfig.from_collate_conf({"spec_aug": True}),
                       False)
    np.testing.assert_array_equal(batch["features_length"].numpy(),
                                  host["features_length"])
    np.testing.assert_allclose(batch["features"].numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
