"""The device trace of a traced window, reduced to what the metrics read.

`Trace.from_profile` keeps the profiler's device events (kernels,
copies, sets) with name, start and duration, and the host's events;
`busy_s` is the union of the device intervals (streams that overlap
count once); `top_ops` the device operations by summed time; `idle_gaps`
the longest gaps between busy intervals, each named by the innermost
host event that was running when it began.
"""

from __future__ import annotations

from dataclasses import dataclass, field


def union_length(intervals: list[tuple[int, int]]) -> int:
    """Total length covered by [start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class Trace:
    device: list[tuple[str, int, int]] = field(default_factory=list)
    host: list[tuple[str, int, int]] = field(default_factory=list)
    window: tuple[int, int] = (0, 0)      # ns, on the profiler's clock

    @classmethod
    def from_profile(cls, prof, window_event: str):
        """The profile's events; the window is the host event named
        `window_event` (a record_function around the traced window)."""
        import torch
        dev_type = torch.autograd.DeviceType.CUDA
        device, host = [], []
        for e in prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == dev_type:
                if not e.is_user_annotation():
                    device.append((e.name(), start, dur))
            elif not e.is_async():
                host.append((e.name(), start, dur))
        marks = [(s, s + d) for n, s, d in host if n == window_event]
        if not marks:
            raise RuntimeError(f"no {window_event!r} event in the profile")
        host = [h for h in host if h[0] != window_event]
        return cls(device, host, marks[0])

    def intervals(self, pred=lambda name: True) -> list[tuple[int, int]]:
        lo, hi = self.window
        return [(max(s, lo), min(s + d, hi)) for n, s, d in self.device
                if pred(n) and s + d > lo and s < hi]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self, pred=lambda name: True) -> float:
        return union_length(self.intervals(pred)) / 1e9

    def kernel_s(self, pred) -> float:
        """Summed device time of the operations whose name passes."""
        return sum(e - s for s, e in self.intervals(pred)) / 1e9

    def top_ops(self, n: int = 10) -> list[list]:
        sums: dict[str, int] = {}
        lo, hi = self.window
        for name, s, d in self.device:
            if s + d > lo and s < hi:
                sums[name] = sums.get(name, 0) + d
        top = sorted(sums.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list[list]:
        busy = merged(self.intervals())
        lo, hi = self.window
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        return [[self.host_at(s), (e - s) / 1e9] for s, e in gaps]

    def host_at(self, t: int) -> str:
        """The innermost host event running at t (the latest to start)."""
        best = None
        for name, s, d in self.host:
            if s <= t < s + d and (best is None or s > best[1]):
                best = (name, s)
        return "idle host" if best is None else best[0][:200]
