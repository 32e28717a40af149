"""Global CMVN statistics loaders (WeNet JSON / kaldi text formats).

Port of openeat_tpu/utils/cmvn.py (numpy only; the port keeps its own
copy): both formats store accumulated sum / sum-of-squares / frame
count, converted to (mean, 1/std) with the same 1e-20 variance floor.
"""

from __future__ import annotations

import json

import numpy as np

VAR_FLOOR = 1.0e-20


def _finalize(mean_stat: np.ndarray, var_stat: np.ndarray,
              count: float) -> tuple[np.ndarray, np.ndarray]:
    mean = mean_stat / count
    var = var_stat / count - mean * mean
    istd = 1.0 / np.sqrt(np.maximum(var, VAR_FLOOR))
    return mean.astype(np.float32), istd.astype(np.float32)


def load_json_cmvn(path: str) -> tuple[np.ndarray, np.ndarray]:
    """WeNet-style JSON: {mean_stat: [...], var_stat: [...], frame_num: N}."""
    with open(path) as f:
        stats = json.load(f)
    return _finalize(np.asarray(stats["mean_stat"], np.float64),
                     np.asarray(stats["var_stat"], np.float64),
                     float(stats["frame_num"]))


def load_kaldi_cmvn(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Kaldi text matrix from `compute-cmvn-stats --binary=false`:

        [ m_1 ... m_D count
          v_1 ... v_D 0 ]
    """
    with open(path, "rb") as f:
        if f.read(2) == b"\0B":
            raise ValueError(
                "binary kaldi cmvn not supported; recompute with "
                "compute-cmvn-stats --binary=false")
    with open(path) as f:
        toks = f.read().split()
    if toks[0] != "[" or toks[-1] != "]":
        raise ValueError(f"malformed kaldi cmvn file {path!r}")
    body = toks[1:-1]
    # two rows of D+1 entries; last entry of row 2 is a structural 0
    dim = len(body) // 2 - 1
    mean_stat = np.asarray([float(x) for x in body[:dim]], np.float64)
    count = float(body[dim])
    var_stat = np.asarray([float(x) for x in body[dim + 1: 2 * dim + 1]],
                          np.float64)
    return _finalize(mean_stat, var_stat, count)


def load_cmvn(path: str, is_json: bool) -> tuple[np.ndarray, np.ndarray]:
    """Returns (mean [D], istd [D]) float32 (reference cmvn.py:88-93)."""
    return load_json_cmvn(path) if is_json else load_kaldi_cmvn(path)
