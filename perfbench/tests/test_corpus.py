"""The traffic generator's lengths and rates at the cells' pool seeds,
and the files it writes, as the program reads them."""

import json

import numpy as np
import pytest

from perfbench import corpus, spec

MIXES = {"aishell_train": (4.5, 3.2, 3000, 120098),
         "librispeech_train": (12.3, 3.5, 2400, 70310)}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_lengths_and_rates(mix):
    mean, rate, n_pool, n_epoch = MIXES[mix]
    t = spec.load_json(spec.PACKAGE_DIR / "traffic" / f"{mix}.json")
    pool = corpus.draw_pool(t)
    epoch = corpus.draw_epoch(t, pool)
    assert len(pool.samples) == n_pool
    assert len(set(pool.samples.tolist())) == n_pool
    d = epoch.durations
    assert len(d) == n_epoch
    assert abs(d.mean() / mean - 1) < 0.02
    half = t["offset_max_s"] / 2
    lo, hi = t["duration_s"]["min"], t["duration_s"]["max"]
    assert d.min() >= lo - half and d.max() <= hi + half + n_pool / 16000
    assert abs(epoch.tokens.sum() / d.sum() / rate - 1) < 0.02
    # offsets on the 1/128 s grid, up to offset_max_s
    assert np.all(epoch.offsets % corpus.OFFSET_STEP == 0)
    assert epoch.offsets.max() == t["offset_max_s"] * corpus.SAMPLE_RATE
    assert np.array_equal(epoch.samples,
                          pool.samples[epoch.files] - epoch.offsets)
    # the same corpus on every call: it comes from the pool seed alone
    again = corpus.draw_epoch(t, corpus.draw_pool(t))
    assert np.array_equal(again.samples, epoch.samples)
    assert np.array_equal(again.files, epoch.files)


def test_token_ids_follow_the_pool_seed():
    t = {"pool_seed": 2 ** 31 + 7}
    tokens = np.array([3, 5])
    a = corpus.draw_token_ids(t, tokens, 50)
    b = corpus.draw_token_ids(t, tokens, 50)
    c = corpus.draw_token_ids({"pool_seed": 2 ** 31 + 8}, tokens, 50)
    assert [len(x) for x in a] == [3, 5]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert all(2 <= v <= 48 for x in a for v in x)


TINY = {"pool_seed": 5, "pool_utterances": 4, "epoch_utterances": 9,
        "offset_max_s": 0.25, "units_per_s": 3.0,
        "duration_s": {"mean": 1.0, "sigma": 0.2, "min": 0.5, "max": 2.0}}


def test_files_written_once_and_the_manifest(tmp_path):
    first = corpus.make_corpus(TINY, 30, tmp_path)
    stamp = first.manifest.stat().st_mtime_ns
    second = corpus.make_corpus(TINY, 30, tmp_path)
    assert second.manifest == first.manifest
    assert second.manifest.stat().st_mtime_ns == stamp
    lines = first.manifest.read_text().splitlines()
    assert len(lines) == 9
    for i, line in enumerate(lines):
        fields = line.split("\t")
        assert len(fields) == 7
        assert fields[0] == f"utt:{first.keys[i]}"
        assert fields[5] == "tokenid:" + " ".join(
            map(str, first.token_ids[i]))
        assert float(fields[2].split(":")[1]) * corpus.SAMPLE_RATE \
            == first.samples[i]
        assert len(first.read(i)) == first.samples[i]
    words = first.dict_path.read_text().split()
    assert words[:2] == ["<blank>", "0"] and words[-2:] == ["<sos/eos>", "29"]
    assert json.dumps(TINY)        # the traffic stays plain data


def test_the_programs_readers_take_each_entrys_samples(tmp_path):
    """Both of the program's readers (the native library where it builds,
    the Python decoder) cut each manifest entry's segment to exactly the
    samples the reference reads."""
    from openeat_torch.dataset.audio import read_wav
    from openeat_torch.dataset.manifest import parse_wav_entry
    from openeat_torch.runtime import native_io
    c = corpus.make_corpus(TINY, 30, tmp_path)
    entries = [line.split("\t")[1].split(":", 1)[1]
               for line in c.manifest.read_text().splitlines()]
    parsed = [parse_wav_entry(e) for e in entries]
    for i, (path, start, end) in enumerate(parsed):
        x, rate = read_wav(path, start, end)
        assert rate == corpus.SAMPLE_RATE
        assert np.array_equal(np.rint(x * 32768).astype(np.int16), c.read(i))
    if native_io.available():
        wav, lens, _ = native_io.read_wav_batch(
            [p[0] for p in parsed], [p[1] for p in parsed],
            [p[2] for p in parsed], 4 * corpus.SAMPLE_RATE, 2)
        for i in range(len(parsed)):
            got = np.rint(wav[i, :lens[i]] * 32768).astype(np.int16)
            assert np.array_equal(got, c.read(i))


def test_speed_perturbation_follows_a_polyphase_resampler():
    """The reference's speed perturbation gives the program's lengths and,
    but for a last bit where the program rounds in float32, its samples."""
    from fractions import Fraction

    sps = pytest.importorskip("scipy.signal")
    from perfbench.reference import speed
    rng = np.random.default_rng(3)
    for n in (16001, 37123):
        x = np.clip(np.rint(rng.standard_normal(n) * 2000), -32768,
                    32767).astype(np.int16)
        for s in (0.9, 1.0, float(np.arange(0.9, 1.15, 0.1)[2])):
            frac = Fraction(s).limit_denominator(100)
            y = x.astype(np.float32) if s == 1.0 else sps.resample_poly(
                x.astype(np.float32), frac.denominator, frac.numerator)
            prog = np.clip(np.rint(y.astype(np.float32)), -32768, 32767)
            mine = speed.perturb(x, s)
            assert len(mine) == len(prog) == speed.length(n, s)
            d = np.abs(mine.astype(np.int64) - prog.astype(np.int64))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_speed_is_read_from_the_frames():
    from perfbench.reference import speed
    speeds = [1.0, 0.9, 1.0, 1.1]
    for n in (19000, 160000, 472000):
        for s in (0.9, 1.0, 1.1):
            got = speed.infer(n, speed.frames(speed.length(n, s)), speeds)
            assert got == pytest.approx(s)
    assert speed.infer(160000, 3, speeds) is None
