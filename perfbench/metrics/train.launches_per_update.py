"""Device operations an update: the kernels, copies and sets of the
traced window over its updates (perfbench/spans.py)."""

from perfbench.spans import launches_per_update


def read(ctx):
    return launches_per_update(ctx)
