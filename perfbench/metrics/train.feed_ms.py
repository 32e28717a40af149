"""Host milliseconds an update in feeding a batch to the device: the
program's span openeat.feed (pipeline.py:DeviceFeeder: padding, the
accumulation split, the copies to the device and the frontend's
launches, not the wait for the loader) over the traced window's updates,
under the profiler (perfbench/spans.py)."""

from perfbench.spans import per_update_ms


def read(ctx):
    return per_update_ms(ctx, "openeat.feed")
