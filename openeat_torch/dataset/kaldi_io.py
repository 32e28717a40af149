"""Kaldi binary ark matrices (host): reader and writers.
Port of openeat_tpu/dataset/kaldi_io.py, a copy kept here so that the
port needs nothing of the JAX package. `data_type: feat` manifests point
at `path:offset` entries of binary kaldi matrices ("\\0B", a token, the
payload), written from the kaldi wire format:

- 'FM' / 'DM': uncompressed float / double matrices (int32 rows and
  cols, then the row-major data);
- 'CM': CompressedMatrix format 1 - a global {min, range, rows, cols},
  per-column uint16 percentile headers (0/25/75/100, each min + range x
  u / 65535), and one uint8 a value, column-major, read by three linear
  pieces with breaks at 64 and 192;
- 'CM2': format 2 - one uint16 a value over [min, min + range].
"""

from __future__ import annotations

import struct

import numpy as np


def _read_int32(f) -> int:
    size = f.read(1)
    assert size == b"\x04", f"expected int32 size marker, got {size!r}"
    return struct.unpack("<i", f.read(4))[0]


def read_mat(path_with_offset: str) -> np.ndarray:
    """Read one matrix from 'file.ark:offset' (kaldi scp convention)."""
    if ":" in path_with_offset:
        path, offset = path_with_offset.rsplit(":", 1)
        offset = int(offset)
    else:
        path, offset = path_with_offset, 0
    with open(path, "rb") as f:
        f.seek(offset)
        binmark = f.read(2)
        if binmark != b"\x00B":
            raise ValueError(
                f"{path}:{offset}: not binary kaldi data (got {binmark!r})")
        token = b""
        while not token.endswith(b" "):
            c = f.read(1)
            if not c:
                raise ValueError("truncated ark")
            token += c
        token = token.strip()
        if token == b"FM":
            dtype, itemsize = "<f4", 4
        elif token == b"DM":
            dtype, itemsize = "<f8", 8
        elif token in (b"CM", b"CM2"):
            return _read_compressed(f, token)
        else:
            raise ValueError(f"unsupported kaldi token {token!r}")
        rows = _read_int32(f)
        cols = _read_int32(f)
        data = np.frombuffer(f.read(rows * cols * itemsize), dtype)
        return data.reshape(rows, cols).astype(np.float32)


def _u16_to_float(u, min_value, rng):
    return min_value + rng * (u.astype(np.float64) / 65535.0)


def _read_compressed(f, token) -> np.ndarray:
    """kaldi CompressedMatrix payload (GlobalHeader + columns)."""
    min_value, rng = struct.unpack("<ff", f.read(8))
    rows, cols = struct.unpack("<ii", f.read(8))
    if token == b"CM2":
        data = np.frombuffer(f.read(rows * cols * 2), "<u2")
        return _u16_to_float(data, min_value, rng).reshape(
            rows, cols).astype(np.float32)
    # format 1: per-column uint16 percentile headers + uint8 data
    heads = np.frombuffer(f.read(cols * 8), "<u2").reshape(cols, 4)
    p = _u16_to_float(heads, min_value, rng)  # [cols, 4] p0,p25,p75,p100
    data = np.frombuffer(f.read(rows * cols), np.uint8).reshape(
        cols, rows).astype(np.float64)  # column-major
    p0, p25, p75, p100 = (p[:, i][:, None] for i in range(4))
    lo = p0 + (p25 - p0) * (data / 64.0)
    mid = p25 + (p75 - p25) * ((data - 64.0) / 128.0)
    hi = p75 + (p100 - p75) * ((data - 192.0) / 63.0)
    out = np.where(data <= 64, lo, np.where(data <= 192, mid, hi))
    return out.T.astype(np.float32)


def write_compressed_ark_entry(f, key: str, mat: np.ndarray) -> int:
    """Append one 'CM' (format 1) entry — the kaldi compression scheme:
    per-column 0/25/75/100 percentiles + 3-segment uint8 quantization."""
    f.write(key.encode() + b" ")
    offset = f.tell()
    rows, cols = mat.shape
    min_value = float(mat.min())
    rng = float(max(mat.max() - min_value, 1e-10))
    f.write(b"\x00BCM ")
    f.write(struct.pack("<ffii", min_value, rng, rows, cols))

    def to_u16(v):
        return np.clip((v - min_value) / rng * 65535.0, 0,
                       65535).astype("<u2")

    heads = []
    bodies = []
    for c in range(cols):
        col = np.sort(mat[:, c].astype(np.float64))
        q = [col[0], col[max(rows // 4 - 1, 0)],
             col[max(3 * rows // 4 - 1, 0)], col[-1]]
        u = to_u16(np.asarray(q))
        # re-derive the floats the reader will see (quantized heads)
        p0, p25, p75, p100 = _u16_to_float(u, min_value, rng)
        heads.append(u)
        x = mat[:, c].astype(np.float64)
        c_lo = np.clip((x - p0) / max(p25 - p0, 1e-10) * 64.0, 0, 64)
        c_mid = 64.0 + np.clip((x - p25) / max(p75 - p25, 1e-10) * 128.0,
                               0, 128)
        c_hi = 192.0 + np.clip((x - p75) / max(p100 - p75, 1e-10) * 63.0,
                               0, 63)
        code = np.where(x < p25, c_lo, np.where(x < p75, c_mid, c_hi))
        bodies.append(np.round(code).astype(np.uint8))
    f.write(np.stack(heads).astype("<u2").tobytes())
    f.write(np.stack(bodies).tobytes())
    return offset


def write_ark_entry(f, key: str, mat: np.ndarray) -> int:
    """Append one binary FM entry; returns the value offset (for scp)."""
    f.write(key.encode() + b" ")
    offset = f.tell()
    f.write(b"\x00BFM ")
    f.write(b"\x04" + struct.pack("<i", mat.shape[0]))
    f.write(b"\x04" + struct.pack("<i", mat.shape[1]))
    f.write(np.ascontiguousarray(mat, "<f4").tobytes())
    return offset
