"""The port's FLAC codec and native reader against the JAX package's.

Samples from seeded numpy. The port decodes, sample for sample, what
JAX's encode_flac writes and JAX decodes what the port's writes: 16 and
24 bits, mono and stereo (independent, left/side), and mid/side and
right/side stereo streams assembled here from the port's own frame
writer (no encoder emits them); read_audio gives JAX's samples for
whole files and segments; a flipped bit and a bad STREAMINFO MD5 raise
in both. The native reader, built with g++ from native/openeat_io.cc
into openeat_torch/_build/ under a name that follows the CPU's
instruction sets, gives the Python decoder's samples exactly
(16-bit mono and stereo, 24-bit mono, segments) and the collate's
batch equals the JAX collate's on a FLAC corpus (the JAX package's
Python reader here: its library is not built).
"""

import os

import numpy as np
import pytest

from openeat_tpu.dataset import audio as jax_audio
from openeat_tpu.dataset import flac as jax_flac
from openeat_tpu.dataset.dataset import AudioCollate as JaxCollate
from openeat_tpu.dataset.dataset import AudioDataset as JaxDataset
from openeat_tpu.dataset.text import load_dict as jax_load_dict
from openeat_torch.dataset import audio, flac
from openeat_torch.dataset.dataset import AudioCollate, AudioDataset
from openeat_torch.dataset.text import load_dict
from openeat_torch.runtime import native_io
from tests.make_tiny_data import build as build_tiny


def _samples(rng, n, nch, bps):
    top = 1 << (bps - 1)
    t = np.arange(n)
    tone = (0.4 * top * np.sin(2 * np.pi * 440 * t / 16000)).astype(np.int64)
    x = np.stack([np.roll(tone, 13 * c) + rng.integers(-top // 8, top // 8, n)
                  for c in range(nch)], axis=1)
    return np.clip(x, -top, top - 1)


def _encode_stereo(samples: np.ndarray, rate: int, bps: int, mode: int,
                   block_size: int = 1024) -> bytes:
    """A stereo stream whose frames use channel assignment `mode` (9:
    right/side, 10: mid/side), built from the port's frame writer."""
    # the marker and STREAMINFO (sample count, MD5) of a plain encode
    out = bytearray(flac.encode_flac(samples, rate, bps)[:42])
    n = samples.shape[0]
    ss_code = {v: k for k, v in flac._SAMPLE_SIZES.items()}[bps]
    for frame_no, off in enumerate(range(0, n, block_size)):
        blk = samples[off:off + block_size].astype(np.int64)
        w = flac._BitWriter()
        w.write(0x3FFE, 14)
        w.write(0, 2)
        w.write(7, 4)
        w.write(5, 4)                      # 16 kHz
        w.write(mode, 4)
        w.write(ss_code, 3)
        w.write(0, 1)
        flac._write_utf8_num(w, frame_no)
        w.write(blk.shape[0] - 1, 16)
        w.write(flac.crc8(bytes(w.buf)), 8)
        left, right = blk[:, 0], blk[:, 1]
        side = left - right
        if mode == 9:
            subs = [(side, bps + 1), (right, bps)]
        else:
            subs = [((left + right) >> 1, bps), (side, bps + 1)]
        for x, b in subs:
            flac._encode_subframe(w, x, b)
        w.align()
        frame = w.getvalue()
        out += frame + flac.crc16(frame).to_bytes(2, "big")
    return bytes(out)


@pytest.mark.parametrize("nch,bps,left_side", [
    (1, 16, False), (2, 16, False), (2, 16, True), (1, 24, False),
    (2, 24, True)])
def test_decode_equals_jax_both_ways(rng, nch, bps, left_side):
    s = _samples(rng, 5000, nch, bps)
    for enc, dec in ((jax_flac.encode_flac, flac.decode_flac),
                     (flac.encode_flac, jax_flac.decode_flac)):
        data = enc(s, 16000, bps=bps, block_size=1024, left_side=left_side)
        got, rate, got_bps = dec(data)
        assert (rate, got_bps) == (16000, bps)
        np.testing.assert_array_equal(got, s)
    assert flac.encode_flac(s, 16000, bps, 1024, left_side) \
        == jax_flac.encode_flac(s, 16000, bps, 1024, left_side)


@pytest.mark.parametrize("mode", [9, 10], ids=["right_side", "mid_side"])
@pytest.mark.parametrize("bps", [16, 24])
def test_stereo_decorrelation_equals_jax(rng, mode, bps):
    s = _samples(rng, 3000, 2, bps)
    data = _encode_stereo(s, 16000, bps, mode)
    got, _, _ = flac.decode_flac(data)
    want, _, _ = jax_flac.decode_flac(data)
    np.testing.assert_array_equal(got, s)
    np.testing.assert_array_equal(got, want)


def test_corruption_and_bad_md5_raise(rng):
    s = _samples(rng, 1500, 1, 16)
    data = bytearray(flac.encode_flac(s, 16000))
    flipped = bytearray(data)
    flipped[-10] ^= 0x40
    bad_md5 = bytearray(data)
    bad_md5[26] ^= 0xFF
    for dec in (flac.decode_flac, jax_flac.decode_flac):
        with pytest.raises(ValueError, match="CRC"):
            dec(bytes(flipped))
        with pytest.raises(ValueError, match="MD5"):
            dec(bytes(bad_md5))
        np.testing.assert_array_equal(
            dec(bytes(bad_md5), verify_md5=False)[0], s)
    with pytest.raises(ValueError, match="fLaC"):
        flac.decode_flac(b"RIFF" + bytes(data[4:]))


def test_read_audio_and_segments_equal_jax(tmp_path, rng):
    x = (0.3 * rng.standard_normal(12000)).astype(np.float32)
    fp, wp = str(tmp_path / "a.flac"), str(tmp_path / "a.wav")
    flac.write_flac(fp, x, 16000)
    audio.write_wav(wp, x, 16000)
    assert open(fp, "rb").read() == _jax_written(tmp_path, x)
    for seg in ((None, None), (0.1, 0.45), (0.2, None)):
        got, rate = audio.read_audio(fp, *seg)
        want, _ = jax_audio.read_audio(fp, *seg)
        assert rate == 16000
        np.testing.assert_array_equal(got, want)
        # the FLAC and the WAV of the same float audio decode alike
        np.testing.assert_array_equal(got, audio.read_audio(wp, *seg)[0])


def _jax_written(tmp_path, x) -> bytes:
    p = str(tmp_path / "jax.flac")
    jax_flac.write_flac(p, x, 16000)
    return open(p, "rb").read()


@pytest.fixture(scope="module")
def native():
    if not native_io.available():
        pytest.fail(f"the native reader did not build: "
                    f"{native_io.build_error}")
    return native_io


def test_native_library_builds_into_the_package(native):
    lib = native.library_path("g++")
    assert lib.exists() and lib.parent.name == "_build"
    assert lib.parent.parent.name == "openeat_torch"


def test_native_library_name_follows_the_cpu(native, monkeypatch):
    """-march=native builds for this CPU: a build made on a CPU with
    other instruction sets has another name, and is never loaded here."""
    assert "#define __" in native.native_target("g++")
    here = native.library_path("g++")
    monkeypatch.setattr(native, "native_target",
                        lambda cxx: "#define __AVX512F__ 1")
    assert native.library_path("g++") != here


@pytest.mark.parametrize("nch,bps", [(1, 16), (2, 16), (1, 24)])
def test_native_reader_equals_python_decoder(native, tmp_path, rng, nch,
                                             bps):
    paths, oracle = [], []
    for i, ls in enumerate((False, True)):
        s = _samples(rng, 4000 + 512 * i, nch, bps)
        p = str(tmp_path / f"n{i}.flac")
        with open(p, "wb") as f:
            f.write(flac.encode_flac(s, 16000, bps=bps, block_size=1024,
                                     left_side=ls and nch == 2))
        paths.append(p)
        oracle.append(audio.read_audio(p)[0])
    wav, lens, rates = native.read_wav_batch(paths, [None] * 2, [None] * 2,
                                             max_samples=8000, n_threads=2)
    for i in range(2):
        assert rates[i] == 16000 and lens[i] == len(oracle[i])
        np.testing.assert_array_equal(wav[i, : lens[i]], oracle[i])
    wav2, lens2, _ = native.read_wav_batch([paths[0]], [0.05], [0.15],
                                           max_samples=8000, n_threads=1)
    np.testing.assert_array_equal(wav2[0, : lens2[0]],
                                  audio.read_audio(paths[0], 0.05, 0.15)[0])
    assert native.wav_info(paths[1]) == (len(oracle[1]), 16000)


def test_collate_reads_flac_natively_as_jax_does(native, tmp_path):
    root = str(tmp_path)
    d = build_tiny(root, n_utts=6, seed=5)
    manifest = os.path.join(root, "format_flac.data")
    with open(d["manifest"]) as f, open(manifest, "w") as out:
        for line in f:
            fields = dict(kv.split(":", 1)
                          for kv in line.rstrip("\n").split("\t"))
            x, rate = audio.read_wav(fields["feat"])
            fields["feat"] = fields["feat"][:-4] + ".flac"
            flac.write_flac(fields["feat"], x, rate)
            out.write("\t".join(f"{k}:{v}" for k, v in fields.items())
                      + "\n")
    kw = dict(batch_type="static", batch_size=6, max_length=100000)
    collate = AudioCollate(speed_perturb_rate=0.5, seed=3)
    assert collate.native_io is True
    keys, got = collate(AudioDataset(manifest, load_dict(d["dict"]),
                                     **kw)[0])
    jkeys, want = JaxCollate(speed_perturb_rate=0.5, seed=3,
                             use_native_io=False)(
        JaxDataset(manifest, jax_load_dict(d["dict"]), **kw)[0])
    assert keys == jkeys
    for k in ("wav", "wav_lens", "targets", "targets_length"):
        np.testing.assert_array_equal(got[k], want[k])
    python_keys, python = AudioCollate(
        speed_perturb_rate=0.5, seed=3, use_native_io=False)(
        AudioDataset(manifest, load_dict(d["dict"]), **kw)[0])
    assert python_keys == keys
    np.testing.assert_array_equal(python["wav"], got["wav"])
