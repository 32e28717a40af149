"""Profiling and step counters (PyTorch). Port of
openeat_tpu/utils/profiling.py:

- `trace(dir, device)` profiles the enclosed steps with torch.profiler,
  CPU and (on a CUDA device) CUDA activity, and writes a Chrome trace
  (`trace_<pid>_<n>.json`, viewable in Perfetto or chrome://tracing)
  under `dir`;
- `annotate(name)` is a named region on that timeline
  (torch.profiler.record_function);
- `StepTimer` keeps the step time and the audio seconds per second per
  card, raw and smoothed by an exponential moving average.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity

_TRACES = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str, device: torch.device):
    """Profile the enclosed block, which runs on `device`; on exit write
    its Chrome trace under `log_dir`. CUDA activity is recorded on a
    CUDA device. Yields the profiler."""
    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if device.type == "cuda":   # the block's kernels end inside
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{next(_TRACES)}.json"))


def annotate(name: str):
    """Named region on the profiler's timeline (a context manager)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Step time and audio throughput counters with EMA smoothing.
    `n_chips` defaults to the process group's world size, or 1 outside
    one."""

    def __init__(self, frame_shift_ms: float = 10.0, ema: float = 0.98,
                 n_chips: int | None = None):
        self.frame_shift_s = frame_shift_ms / 1000.0
        self.ema = ema
        if n_chips is None:
            n_chips = dist.get_world_size() if dist.is_initialized() else 1
        self.n_chips = n_chips
        self._last = None
        self.step_time_ema = None
        self.audio_per_sec_ema = None
        self.steps = 0

    def tick(self, n_frames: int) -> dict:
        """Call once per step with the batch's total valid frame count;
        returns the counters from the second call on ({} on the
        first)."""
        now = time.perf_counter()
        out = {}
        if self._last is not None:
            dt = now - self._last
            audio_s = n_frames * self.frame_shift_s
            rate = audio_s / dt / self.n_chips
            if self.step_time_ema is None:
                self.step_time_ema = dt
                self.audio_per_sec_ema = rate
            else:
                self.step_time_ema = (self.ema * self.step_time_ema
                                      + (1 - self.ema) * dt)
                self.audio_per_sec_ema = (self.ema * self.audio_per_sec_ema
                                          + (1 - self.ema) * rate)
            out = {"step_time_s": dt,
                   "step_time_ema_s": self.step_time_ema,
                   "audio_sec_per_sec_per_chip": rate,
                   "audio_sec_per_sec_per_chip_ema":
                       self.audio_per_sec_ema}
        self._last = now
        self.steps += 1
        return out
