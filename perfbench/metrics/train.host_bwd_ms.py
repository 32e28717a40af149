"""Host milliseconds an update in the backward: the program's span
openeat.step.backward (parallel/train_step.py:_loss_and_grads, each
micro-batch's loss.backward(), the autograd engine's launches included)
over the traced window's updates: a profiled host time, which the
profiler inflates more than the forward's, so this reading and
train.host_fwd_ms do not rank the two as the untraced program would
(perfbench/spans.py)."""

from perfbench.spans import per_update_ms


def read(ctx):
    return per_update_ms(ctx, "openeat.step.backward")
