"""The whole training step's share of the card's bf16 peak over the
measured (untraced) window: the model FLOPs of the updates completed
(forward from each utterance's frames as the program fed them,
perfbench/flops.py, times 3 for forward and backward) over the window
and the peak, in %."""


def read(ctx):
    rec = ctx.record
    if ctx.kind != "train" or ctx.peaks is None or not rec.updates \
            or rec.flops <= 0:
        return None
    return 100.0 * rec.flops / (ctx.window_s * ctx.peaks["bf16_flops"])
