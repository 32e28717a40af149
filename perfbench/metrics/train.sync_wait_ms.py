"""Milliseconds an update the host waited to read whether the norm is
finite, the step's one device-to-host read: the program's span
openeat.step.sync (parallel/train_step.py:apply_update), over the traced
window's updates, under the profiler (perfbench/spans.py). It holds the
device's backlog at that point."""

from perfbench.spans import per_update_ms


def read(ctx):
    return per_update_ms(ctx, "openeat.step.sync")
