"""The program's spans in the traced training window.

openeat_torch/utils/profiling.py:span is a torch.profiler region while a
profiler runs, so the traced window's host events hold each span with
its start and duration. The readers take the stepping thread's spans by
name and divide by the traced window's updates. A trace without these
spans (a program that opens none) gives no reading.

The host times read here are profiled times. The profiler records every
op the host runs and so slows the backward (whose ops the autograd
thread runs) more than the forward: on the H100 the backward read
1.7-3.5x, the forward 1.0-1.6x and clip + Adam 1.3-2.1x the same spans
untraced. Compare a host time between two versions of the program, each
profiled; the order of the forward against the backward here is not the
untraced program's.
"""

from __future__ import annotations

from perfbench.trace import union_length

# the spans of the thread that steps the program, and the outermost of
# them, which hold the rest
MAIN = ("openeat.step", "openeat.step.forward", "openeat.step.backward",
        "openeat.step.update", "openeat.step.sync", "openeat.loader.wait",
        "openeat.feed")
TOP = ("openeat.step", "openeat.loader.wait", "openeat.feed")


def _updates(ctx) -> int:
    if ctx.kind != "train" or ctx.trace is None or ctx.traced is None:
        return 0
    return ctx.traced.updates


def spans(trace, names) -> list[tuple[int, int]]:
    """[start, end) of the host events named in `names` that start in the
    traced window."""
    lo, hi = trace.window
    return [(s, s + d) for n, s, d in trace.host
            if n in names and lo <= s < hi]


def per_update_ms(ctx, name: str, less: tuple[str, ...] = ()) -> \
        float | None:
    """Milliseconds an update in the spans `name`, less the time that the
    spans named in `less` (its children) cover inside them."""
    n = _updates(ctx)
    own = spans(ctx.trace, (name,)) if n else []
    if not own:
        return None
    inner = spans(ctx.trace, less) if less else []
    # the time own covers and inner does not: |own u inner| - |inner|
    ns = union_length(own + inner) - union_length(inner)
    return ns / 1e6 / n


def launches_per_update(ctx) -> float | None:
    """Device operations (kernels, copies, sets) in the traced window an
    update."""
    n = _updates(ctx)
    ops = len(ctx.trace.intervals()) if n else 0
    return ops / n if ops else None


def idle_unspanned_ms(ctx) -> float | None:
    """Milliseconds an update in which the device ran nothing while the
    stepping thread was in none of its spans."""
    n = _updates(ctx)
    if not n:
        return None
    busy = ctx.trace.intervals()
    main = spans(ctx.trace, MAIN)
    if not busy or not main:
        return None
    lo, hi = ctx.trace.window
    main = [(s, min(e, hi)) for s, e in main]
    return (hi - lo - union_length(busy + main)) / 1e6 / n
