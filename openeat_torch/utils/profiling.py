"""Profiling and spans (PyTorch). Port of openeat_tpu/utils/profiling.py's
trace, and the port's own spans:

- `trace(dir, device)` profiles the enclosed steps with torch.profiler,
  CPU and (on a CUDA device) CUDA activity, and writes a Chrome trace
  (`trace_<pid>_<n>.json`, viewable in Perfetto or chrome://tracing)
  under `dir`;
- `span(name)` is a named region of the program. While a profiler runs
  it is a torch.profiler region, on the device trace's clock beside the
  kernels it launched; otherwise it is one shared nullcontext, which
  reads no clock and allocates nothing.
"""

from __future__ import annotations

import contextlib
import itertools
import os

import torch
from torch.profiler import ProfilerActivity

_TRACES = itertools.count()
_OFF = contextlib.nullcontext()


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


def span(name: str):
    """The region `name` of the program (a context manager): a profiler
    region while a profiler runs, else the shared nullcontext."""
    if getattr(torch.autograd.profiler, "_is_profiler_enabled", True):
        return torch.profiler.record_function(name)
    return _OFF
