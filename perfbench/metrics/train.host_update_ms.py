"""Host milliseconds an update in the clip and Adam less the read of the
norm: the self time of the program's span openeat.step.update
(parallel/train_step.py:apply_update: zero-filled gradients, the global
norm, the clip, Adam's step) less openeat.step.sync inside it, over the
traced window's updates: a profiled host time, above the untraced one
(perfbench/spans.py)."""

from perfbench.spans import per_update_ms


def read(ctx):
    return per_update_ms(ctx, "openeat.step.update",
                         less=("openeat.step.sync",))
