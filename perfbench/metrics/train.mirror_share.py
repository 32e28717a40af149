"""Percent of the traced window's updates that wrote the weight mirror:
the program's spans openeat.step.mirror (openeat_torch/utils/
weight_mirror.py: the clip + Adam launch that writes the float32
parameters and their bfloat16 copy, inside openeat.step.update) over the
traced window's updates. An update skipped on a non-finite norm writes
nothing. A program without the mirror's kernels (no openeat_mt_norm
region in the trace) gives no reading."""

from perfbench.spans import spans


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or ctx.traced is None \
            or not ctx.traced.updates \
            or not spans(ctx.trace, ("openeat_mt_norm",)):
        return None
    wrote = len(spans(ctx.trace, ("openeat.step.mirror",)))
    return 100.0 * wrote / ctx.traced.updates
