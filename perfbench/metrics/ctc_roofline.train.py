"""Share of its roofline the CTC kernels K1 and K2 reached in the traced
training window: the least time of every launch, from the program's
launch counters by [B, T, S] and perfbench/flops.py, over the device
time of the kernels whose names hold "ctc_dp_", in %."""

from perfbench.flops import ctc_bound_s


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or ctx.peaks is None:
        return None
    bound = sum(n * ctc_bound_s(*key[-3:], ctx.peaks)
                for key, n in ctx.launches.get("ctc", {}).items())
    spent = ctx.trace.kernel_s(lambda name: "ctc_dp_" in name)
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent
