"""The one general generator of training and test corpora.

A traffic file (perfbench/traffic/<mix>.json) gives the parameters; this
module makes the corpus, from the traffic's `pool_seed` alone, so that
every run seed gets the same corpus:

- the pool: `pool_utterances` file lengths drawn from a log-normal of
  mean `duration_s.mean` and shape `duration_s.sigma`, clipped to [min,
  max], made distinct, each lengthened by half of `offset_max_s`; the
  files are 16 kHz 16-bit mono WAVs of seeded noise (the content does not
  change the work).
- the epoch: `epoch_utterances` manifest entries, as many as the real
  corpus holds, so that an epoch lasts as long as the corpus's and the
  loader starts a new one as rarely. Each entry is a segment of a pool
  file drawn with replacement: the file from a start offset, a whole
  number of 1/128 s (125 samples, exact in binary) up to `offset_max_s`,
  to its end. So entries that share a file differ in their samples and
  length, and the entries' lengths keep the traffic's mean. Each entry
  has its own token count, `units_per_s` times its length times a
  uniform jitter of +-`units_jitter`, and token ids uniform over the
  dictionary less blank, unk and sos/eos.
- the files the program reads: the WAVs, the 7-field manifest and the
  dictionary, written once per machine side under the temporary
  directory (TMPDIR) in a directory named by a hash of the traffic, the
  dictionary's size and this generator, and read again by later runs
  there.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import wave
from dataclasses import dataclass
from pathlib import Path

import numpy as np

SAMPLE_RATE = 16000
OFFSET_STEP = 125            # samples: 1/128 s, so start_s * rate is exact
GENERATOR_VERSION = "2"
SIZE_KEYS = ("pool_seed", "pool_utterances", "duration_s", "units_per_s",
             "units_jitter", "epoch_utterances", "offset_max_s",
             "noise_amplitude")


@dataclass
class Pool:
    """Sizes and files of a traffic mix's WAV files (index order)."""

    samples: np.ndarray      # int64 [N], distinct
    wav_dir: Path | None = None

    def path(self, i: int) -> Path:
        return self.wav_dir / f"u{i:06d}.wav"


@dataclass
class Epoch:
    """The manifest's entries: entry i is pool file files[i] from sample
    offsets[i] on, samples[i] long, with tokens[i] tokens."""

    files: np.ndarray
    offsets: np.ndarray
    samples: np.ndarray
    tokens: np.ndarray

    @property
    def durations(self) -> np.ndarray:
        return self.samples / SAMPLE_RATE


def offset_steps(traffic: dict) -> int:
    return int(round(float(traffic.get("offset_max_s", 0.0)) * SAMPLE_RATE
                     / OFFSET_STEP))


def draw_pool(traffic: dict) -> Pool:
    """The pool's file lengths from the traffic's pool_seed."""
    rng = np.random.default_rng(int(traffic["pool_seed"]))
    d = traffic["duration_s"]
    n = int(traffic["pool_utterances"])
    sigma = float(d["sigma"])
    mu = np.log(float(d["mean"])) - sigma ** 2 / 2
    dur = np.clip(rng.lognormal(mu, sigma, n), d["min"], d["max"])
    samples = np.sort(np.rint(dur * SAMPLE_RATE).astype(np.int64))
    # distinct lengths: lift each past its predecessor
    samples = np.maximum.accumulate(samples - np.arange(n)) + np.arange(n)
    samples += offset_steps(traffic) * OFFSET_STEP // 2
    return Pool(samples[rng.permutation(n)])      # not in length order


def draw_epoch(traffic: dict, pool: Pool) -> Epoch:
    """The epoch's entries from the traffic's pool_seed."""
    rng = np.random.default_rng([int(traffic["pool_seed"]), 3])
    n = int(traffic["epoch_utterances"])
    files = rng.integers(0, len(pool.samples), n)
    offsets = rng.integers(0, offset_steps(traffic) + 1, n) * OFFSET_STEP
    samples = pool.samples[files] - offsets
    jitter = float(traffic.get("units_jitter", 0.0))
    rate = float(traffic["units_per_s"]) * rng.uniform(1 - jitter, 1 + jitter,
                                                       n)
    tokens = np.maximum(1, np.rint(samples / SAMPLE_RATE * rate)).astype(
        np.int64)
    return Epoch(files, offsets, samples, tokens)


def draw_token_ids(traffic: dict, tokens: np.ndarray, vocab_size: int
                   ) -> list[np.ndarray]:
    """Each entry's token ids: uniform over 2 .. vocab_size - 2 (0 is
    blank, 1 unk, vocab_size - 1 sos/eos)."""
    rng = np.random.default_rng([int(traffic["pool_seed"]), 2])
    flat = rng.integers(2, vocab_size - 1, int(np.sum(tokens)))
    return np.split(flat, np.cumsum(tokens)[:-1])


def cache_key(traffic: dict, vocab_size: int) -> str:
    fields = {k: traffic[k] for k in SIZE_KEYS if k in traffic}
    text = json.dumps([fields, vocab_size], sort_keys=True) \
        + GENERATOR_VERSION
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def write_wav(path: Path, samples: np.ndarray) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(samples.astype("<i2").tobytes())


def read_wav(path: Path) -> np.ndarray:
    """int16 samples of a file this module wrote."""
    with wave.open(str(path), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def write_dict(path: Path, vocab_size: int) -> None:
    """<blank> 0, <unk> 1, u2 .. u{V-2}, <sos/eos> V-1."""
    with open(path, "w", encoding="utf-8") as f:
        f.write("<blank> 0\n<unk> 1\n")
        for i in range(2, vocab_size - 1):
            f.write(f"u{i} {i}\n")
        f.write(f"<sos/eos> {vocab_size - 1}\n")


def entry_path(pool: Pool, epoch: Epoch, i: int) -> str:
    """The manifest's `path,start_s,end_s` of entry i: from its offset to
    past the file's end (the readers stop there), both on the 1/128 s
    grid, so start_s * 16000 is the offset exactly."""
    j = int(epoch.files[i])
    end = -(-int(pool.samples[j]) // OFFSET_STEP) * OFFSET_STEP
    return (f"{pool.path(j)},{int(epoch.offsets[i]) / SAMPLE_RATE!r},"
            f"{end / SAMPLE_RATE!r}")


def write_manifest(path: Path, pool: Pool, epoch: Epoch,
                   token_ids: list[np.ndarray], vocab_size: int
                   ) -> list[str]:
    """The 7-field format.data manifest (token ids given, so the program
    tokenizes nothing); returns the keys in manifest order."""
    names = [str(i) for i in range(vocab_size)]
    keys = [f"e{i:07d}" for i in range(len(epoch.files))]
    with open(path, "w", encoding="utf-8") as f:
        for i, (key, ids) in enumerate(zip(keys, token_ids)):
            dur = repr(float(epoch.samples[i]) / SAMPLE_RATE)
            f.write(f"utt:{key}\tfeat:{entry_path(pool, epoch, i)}\t"
                    f"feat_shape:{dur}\ttext:-\ttoken:-\t"
                    f"tokenid:{' '.join([names[t] for t in ids.tolist()])}\t"
                    f"token_shape:{len(ids)},{vocab_size}\n")
    return keys


@dataclass
class Corpus:
    """A traffic mix's corpus: the pool, the epoch, the transcripts and
    the files the program reads."""

    pool: Pool
    epoch: Epoch
    token_ids: list[np.ndarray]
    keys: list[str]
    manifest: Path
    dict_path: Path
    vocab_size: int

    @property
    def samples(self) -> np.ndarray:
        return self.epoch.samples

    @property
    def tokens(self) -> np.ndarray:
        return self.epoch.tokens

    def read(self, i: int) -> np.ndarray:
        """Entry i's int16 samples, read as the manifest says."""
        x = read_wav(self.pool.path(int(self.epoch.files[i])))
        return x[int(self.epoch.offsets[i]):]

    def index(self) -> dict[str, int]:
        return {k: i for i, k in enumerate(self.keys)}


def make_corpus(traffic: dict, vocab_size: int,
                cache_root: Path | None = None) -> Corpus:
    """The corpus, its files written unless an earlier run on this machine
    side wrote them (a directory is renamed into place whole)."""
    pool = draw_pool(traffic)
    epoch = draw_epoch(traffic, pool)
    ids = draw_token_ids(traffic, epoch.tokens, vocab_size)
    keys = [f"e{i:07d}" for i in range(len(epoch.files))]
    root = Path(cache_root or tempfile.gettempdir()) / "perfbench-pool"
    final = root / cache_key(traffic, vocab_size)
    if not (final / "done").is_file():
        root.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(dir=root, prefix="partial-"))
        rng = np.random.default_rng([int(traffic["pool_seed"]), 1])
        amp = float(traffic.get("noise_amplitude", 2000.0))
        pool.wav_dir = final
        for i, n in enumerate(pool.samples):
            x = rng.standard_normal(int(n), dtype=np.float32) * amp
            write_wav(tmp / pool.path(i).name,
                      np.clip(np.rint(x), -32768, 32767))
        write_dict(tmp / "dict.txt", vocab_size)
        write_manifest(tmp / "format.data", pool, epoch, ids, vocab_size)
        (tmp / "done").write_text("")
        try:
            os.rename(tmp, final)
        except OSError:          # another process put its copy there first
            shutil.rmtree(tmp, ignore_errors=True)
    pool.wav_dir = final
    return Corpus(pool, epoch, ids, keys, final / "format.data",
                  final / "dict.txt", vocab_size)
