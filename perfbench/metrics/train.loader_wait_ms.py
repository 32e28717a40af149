"""Milliseconds an update the stepping thread waited on the loader's
collate threads: the program's span openeat.loader.wait
(dataset/dataset.py:PrefetchLoader, around a batch's future) over the
traced window's updates, under the profiler (perfbench/spans.py)."""

from perfbench.spans import per_update_ms


def read(ctx):
    return per_update_ms(ctx, "openeat.loader.wait")
