"""Share of its roofline the depthwise-convolution kernel K3 (forward,
dgrad and wgrad) reached in the traced training window: the least time
of every launch, from the program's launch counters by shape and
perfbench/flops.py, over the device time of the kernels whose names
hold "dwconv1d", in %."""

from perfbench.flops import dwconv_bound_s


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or ctx.peaks is None:
        return None
    bound = 0.0
    for entry in ("fwd", "dgrad", "wgrad"):
        for (b, t_in, c, k, dtype), n in ctx.launches.get(entry, {}).items():
            size = 2 if dtype in ("bfloat16", "float16") else 4
            bound += n * dwconv_bound_s(entry, b, t_in, c, k, size,
                                        ctx.peaks)
    spent = ctx.trace.kernel_s(lambda name: "dwconv1d" in name)
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent
