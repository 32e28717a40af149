"""Learning-rate schedule. Port of openeat_tpu/utils/scheduler.py.

WarmupLR (reference openeat/utils/scheduler.py:9-52): lr *
warmup_steps^0.5 * min(step^-0.5, step * warmup_steps^-1.5), Noam warmup
that reaches lr at warmup_steps and decays as step^-0.5 after it. A pure
function of the step, clamped to step >= 1. The train step evaluates it
at the count of updates already applied, as optax does (0 on the first
update), and sets the optimizer's lr itself; no LRScheduler steps it.
"""

from __future__ import annotations

from typing import Callable


def warmup_lr(lr: float, warmup_steps: int) -> Callable[[int], float]:
    """Returns schedule(step) -> learning rate."""
    warmup_steps = max(int(warmup_steps), 1)

    def schedule(step: int) -> float:
        s = max(float(step), 1.0)
        return lr * warmup_steps ** 0.5 * min(s ** -0.5,
                                              s * warmup_steps ** -1.5)

    return schedule
