"""Median milliseconds of the clip and the Adam update (the train step's
apply_update, ended by a synchronise), from the updates timed after the
traced window."""

import statistics


def read(ctx):
    if ctx.kind != "train" or not ctx.record.update_s:
        return None
    return 1e3 * statistics.median(ctx.record.update_s)
