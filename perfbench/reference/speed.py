"""Online speed perturbation, worked out again: sox's `speed` effect,
a waveform resampled by `speed` and played at the nominal rate.

The rational ratio is the speed as a fraction of denominator at most
100 (0.9 -> 9/10, 1.1 -> 11/10): up = its denominator, down = its
numerator. The low-pass filter is the windowed sinc of a polyphase
resampler: 2 * 10 * max(up, down) + 1 taps, cutoff 1 / max(up, down) of
Nyquist, a Kaiser window of beta 5, unit gain at DC times `up`. The
output has ceil(n * up / down) samples, its first at the filter's
centre. Computed in float64 and rounded to 16-bit PCM.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch


def ratio(speed: float) -> tuple[int, int]:
    """(up, down) of `speed`."""
    frac = Fraction(float(speed)).limit_denominator(100)
    return frac.denominator, frac.numerator


def length(n: int, speed: float) -> int:
    """Samples of an n-sample waveform played at `speed`."""
    up, down = ratio(speed)
    return -(-n * up // down)


def frames(n: int) -> int:
    """25 ms / 10 ms fbank frames of an n-sample waveform."""
    return (n - 400) // 160 + 1


def lowpass(up: int, down: int) -> np.ndarray:
    top = max(up, down)
    half = 10 * top
    m = np.arange(2 * half + 1) - half
    h = np.sinc(m / top) / top * np.kaiser(2 * half + 1, 5.0)
    return h / h.sum() * up


def perturb(x: np.ndarray, speed: float, device=None) -> np.ndarray:
    """x (int16 samples) at `speed`, as int16."""
    up, down = ratio(speed)
    if up == down:
        return np.asarray(x, np.int16)
    h = lowpass(up, down)
    half = (len(h) - 1) // 2
    pre = down - half % down            # zeros before the filter
    hp = np.concatenate([np.zeros(pre), h])
    n, taps = len(x), len(hp)
    n_out = length(n, speed)
    first = (half + pre) // down        # outputs dropped at the start
    dev = torch.device("cpu") if device is None else device
    xs = torch.as_tensor(np.asarray(x, np.float64), device=dev)
    hs = torch.as_tensor(hp, device=dev)
    # y[m] = sum_k hp[k] * up_x[t - k], t = (m + first) * down, where the
    # zero-stuffed up_x[i * up] = x[i]: only k = t - i * up contribute
    t = (torch.arange(n_out, device=dev, dtype=torch.int64) + first) * down
    y = torch.zeros(n_out, dtype=torch.float64, device=dev)
    for j in range(-(-taps // up) + 1):
        i = t // up - j
        k = t - i * up
        ok = (i >= 0) & (i < n) & (k < taps)
        y += torch.where(ok, hs[k.clamp(max=taps - 1)]
                         * xs[i.clamp(0, n - 1)], 0.0)
    return np.clip(np.rint(y.cpu().numpy()), -32768, 32767).astype(np.int16)


def infer(n: int, observed_frames: int, speeds) -> float | None:
    """The speed among `speeds` at which an n-sample waveform gives
    `observed_frames` fbank frames; None when none or two that differ in
    length do."""
    hits = {length(n, s): s for s in speeds
            if frames(length(n, s)) == observed_frames}
    return next(iter(hits.values())) if len(hits) == 1 else None
