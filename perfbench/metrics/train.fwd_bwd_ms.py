"""Median milliseconds of the forward and backward over an update's
micro-batches (the train step's _loss_and_grads, ended by a
synchronise), from the updates timed after the traced window."""

import statistics


def read(ctx):
    if ctx.kind != "train" or not ctx.record.fwd_bwd_s:
        return None
    return 1e3 * statistics.median(ctx.record.fwd_bwd_s)
