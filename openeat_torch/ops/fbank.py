"""Kaldi-compatible log-mel filterbank on the device (PyTorch).

Port of openeat_tpu/ops/fbank.py, framed-matmul path, no dither:
framing (snip_edges) -> DC removal -> preemphasis (0.97) -> povey window
-> real DFT of the zero-padded 512-point frame as one matmul against
``dft_basis`` -> power spectrum -> mel matmul -> log. ``mel_banks`` and
``dft_basis`` are host numpy, copied from the JAX package.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

MEL_BREAK_FREQ = 700.0
MEL_HIGH_FREQ_Q = 1127.0
EPS = float(np.finfo(np.float32).eps)


def mel_scale(freq):
    return MEL_HIGH_FREQ_Q * np.log(1.0 + freq / MEL_BREAK_FREQ)


def num_frames(num_samples, frame_len: int, frame_shift: int):
    """snip_edges=True frame count: 1 + floor((N - len) / shift), min 0."""
    n = (num_samples - frame_len) // frame_shift + 1
    if isinstance(n, torch.Tensor):
        return n.clamp(min=0)
    return max(int(n), 0)


@functools.lru_cache(maxsize=8)
def mel_banks(num_bins: int, window_size_padded: int, sample_freq: float,
              low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """[num_fft_bins+1, num_bins] triangular mel weights (kaldi layout);
    the final (nyquist) row is zero."""
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    if not 0.0 <= low_freq < high_freq <= nyquist:
        raise ValueError(f"bad mel range [{low_freq}, {high_freq}]")
    num_fft_bins = window_size_padded // 2
    fft_bin_width = sample_freq / window_size_padded
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    bins = np.arange(num_bins, dtype=np.float64)
    left = mel_low + bins * mel_delta
    center = mel_low + (bins + 1.0) * mel_delta
    right = mel_low + (bins + 2.0) * mel_delta
    freqs = fft_bin_width * np.arange(num_fft_bins, dtype=np.float64)
    mels = mel_scale(freqs)[:, None]
    up = (mels - left[None, :]) / (center - left)[None, :]
    down = (right[None, :] - mels) / (right - center)[None, :]
    out = np.zeros((num_fft_bins + 1, num_bins), dtype=np.float32)
    out[:num_fft_bins] = np.maximum(0.0, np.minimum(up, down))
    return out


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=8)
def dft_basis(frame_len: int, padded: int) -> np.ndarray:
    """[frame_len, 2*(padded//2+1)] real-DFT basis (cos block, then -sin
    block): power = (f@C)^2 + (f@S)^2 for a zero-padded rFFT."""
    n = np.arange(frame_len, dtype=np.float64)[:, None]
    k = np.arange(padded // 2 + 1, dtype=np.float64)[None, :]
    theta = 2.0 * math.pi * n * k / padded
    return np.concatenate([np.cos(theta), -np.sin(theta)],
                          axis=1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def povey_window(frame_len: int) -> np.ndarray:
    win_n = np.arange(frame_len, dtype=np.float64)
    return ((0.5 - 0.5 * np.cos(2.0 * math.pi * win_n / (frame_len - 1)))
            ** 0.85).astype(np.float32)


def fbank(wav: torch.Tensor, wav_lens: torch.Tensor, *,
          sample_rate: int = 16000, num_mel_bins: int = 80,
          frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
          preemphasis: float = 0.97, remove_dc_offset: bool = True
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched kaldi fbank. wav: [B, N] float32 or int16 (x32768 scaled),
    wav_lens: [B] sample counts. Returns (feats [B, T, M] float32,
    flens [B]); frames past flens[b] are garbage for the caller to mask."""
    wav = wav.float()
    n = wav.shape[1]
    frame_len = int(sample_rate * frame_length_ms / 1000.0)
    frame_shift = int(sample_rate * frame_shift_ms / 1000.0)
    t = num_frames(n, frame_len, frame_shift)
    if t <= 0:
        raise ValueError(f"waveform too short: {n} samples < {frame_len}")
    padded = next_pow2(frame_len)
    nb = padded // 2 + 1
    dev = wav.device
    frames = wav.unfold(1, frame_len, frame_shift)[:, :t]   # [B, T, L]
    if remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis * prev
    frames = frames * torch.from_numpy(povey_window(frame_len)).to(dev)
    basis = torch.from_numpy(dft_basis(frame_len, padded)).to(dev)
    spec = torch.matmul(frames, basis)
    power = spec[..., :nb] ** 2 + spec[..., nb:] ** 2
    mel = torch.from_numpy(
        mel_banks(num_mel_bins, padded, float(sample_rate))).to(dev)
    feats = torch.log(torch.clamp(torch.matmul(power, mel), min=EPS))
    flens = num_frames(wav_lens.long(), frame_len, frame_shift)
    return feats, flens
