"""Host milliseconds an update in the model's forward: the program's span
openeat.step.forward (parallel/train_step.py:_loss_and_grads, each
micro-batch's loss) over the traced window's updates: a profiled host time,
which the profiler inflates less than the backward's, so this reading and
train.host_bwd_ms do not rank the two as the untraced program would
(perfbench/spans.py)."""

from perfbench.spans import per_update_ms


def read(ctx):
    return per_update_ms(ctx, "openeat.step.forward")
