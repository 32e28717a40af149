"""Host audio IO: WAV reading and writing, resampling.
Port of openeat_tpu/dataset/audio.py for WAV; FLAC comes with a later
slice."""

from __future__ import annotations

import struct
import wave
from fractions import Fraction

import numpy as np
from scipy import signal as sps


def read_wav(path: str, start_s: float | None = None,
             end_s: float | None = None) -> tuple[np.ndarray, int]:
    """Read (mono-ized) PCM/float WAV -> (float32 in [-1, 1], rate);
    [start_s, end_s) slices a segment."""
    with open(path, "rb") as f:
        header = f.read(12)
        if header[:4] == b"fLaC":
            raise NotImplementedError(
                f"{path}: FLAC input is not ported to openeat_torch yet "
                "(a later slice); convert to WAV")
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                break
            cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(size)
            elif cid == b"data":
                data = f.read(size)
            else:
                f.seek(size + (size & 1), 1)
            if fmt is not None and data is not None:
                break
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, rate = struct.unpack("<HHI", fmt[:8])
    bits = struct.unpack("<H", fmt[14:16])[0]
    if audio_format == 0xFFFE and len(fmt) >= 26:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]
    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(data, "u1").astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(data, "u1").reshape(-1, 3)
            x = ((raw[:, 0].astype(np.int32))
                 | (raw[:, 1].astype(np.int32) << 8)
                 | (raw[:, 2].astype(np.int32) << 16))
            x = np.where(x >= 1 << 23, x - (1 << 24), x)
            x = x.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"{path}: unsupported PCM bits={bits}")
    elif audio_format == 3 and bits == 32:  # IEEE float
        x = np.frombuffer(data, "<f4").astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported format {audio_format}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    if start_s is not None or end_s is not None:
        s = int((start_s or 0.0) * rate)
        e = int(end_s * rate) if end_s is not None else len(x)
        x = x[s:e]
    return np.ascontiguousarray(x), rate


def write_wav(path: str, x: np.ndarray, rate: int) -> None:
    """Write mono float32 [-1, 1] as 16-bit PCM."""
    pcm = np.clip(x * 32768.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def resample(x: np.ndarray, orig_rate: int, new_rate: int) -> np.ndarray:
    """Polyphase rate conversion."""
    if orig_rate == new_rate:
        return x
    frac = Fraction(new_rate, orig_rate).limit_denominator(1000)
    return sps.resample_poly(x, frac.numerator, frac.denominator).astype(
        np.float32)
