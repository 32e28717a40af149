"""The numbers that decide `correct` for a training cell.

The program and the reference each take the same first updates from
the same weights, corpus and generator seeds, and report:
- `losses`: each update's loss;
- `grad_norms`: each leaf's norm of the first gradient as the optimizer
  got it (clipped);
- `delta_norms`: each leaf's norm of the parameters' change over the
  updates.

From them, each number a gap relative to the reference:
- `loss_gap`: the largest |loss - loss_ref| / |loss_ref| over the updates;
- `grad_gap`: the worst leaf's |norm - norm_ref| / max(norm_ref, the
  median leaf's norm_ref);
- `delta_gap`: the same of the change, leaving out the leaves whose
  reference gradient is under 1e-3 of the median leaf's (a key's bias
  under softmax: its gradient is zero but for rounding, and Adam moves
  it by its sign).

A cell's limits file names the numbers it compares under `limits` (a
number passes at or under its limit) and under `at_least` the counts
that must reach theirs: `ctc_shared_launches` and `ctc_global_launches`,
the launches of K1 and K2 in the updates the check follows, so that the
comparison covers both CTC kernels.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, field

EXCLUDE_BELOW = 1e-3
NUMBERS = ("loss_gap", "grad_gap", "delta_gap")


@dataclass
class Readings:
    losses: list[float] = field(default_factory=list)
    grad_norms: dict[str, float] = field(default_factory=dict)
    delta_norms: dict[str, float] = field(default_factory=dict)


def leaf_gaps(mine: dict, ref: dict, names) -> dict[str, float]:
    """Each leaf's |norm - norm_ref| / max(norm_ref, the median leaf's)."""
    names = list(names)
    med = statistics.median(ref[n] for n in names)
    out = {}
    for n in names:
        gap = abs(mine[n] - ref[n]) / max(ref[n], med, 1e-30)
        out[n] = gap if math.isfinite(gap) else math.inf
    return out


def _worst(mine: dict, ref: dict, names) -> tuple[float, str]:
    gaps = leaf_gaps(mine, ref, names)
    which = max(gaps, key=gaps.get)
    return gaps[which], which


def compare(mine: Readings, ref: Readings) -> dict[str, float]:
    if len(mine.losses) != len(ref.losses) or not ref.losses:
        return dict.fromkeys(NUMBERS, math.inf)
    steps = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
             for a, b in zip(mine.losses, ref.losses)]
    med = statistics.median(ref.grad_norms.values())
    kept = [n for n, g in ref.grad_norms.items() if g >= EXCLUDE_BELOW * med]
    grads = leaf_gaps(mine.grad_norms, ref.grad_norms, ref.grad_norms)
    deltas = leaf_gaps(mine.delta_norms, ref.delta_norms, kept)
    return {"loss_gap": max(steps), "grad_gap": max(grads.values()),
            "delta_gap": max(deltas.values())}


def worst_leaves(mine: Readings, ref: Readings) -> dict[str, str]:
    """Which leaf sets each leaf number (for the record)."""
    if not ref.grad_norms or not mine.grad_norms:
        return {}
    med = statistics.median(ref.grad_norms.values())
    kept = [n for n, g in ref.grad_norms.items() if g >= EXCLUDE_BELOW * med]
    return {"grad_gap": _worst(mine.grad_norms, ref.grad_norms,
                               ref.grad_norms)[1],
            "delta_gap": _worst(mine.delta_norms, ref.delta_norms, kept)[1]}


def excluded(ref: Readings) -> list[str]:
    if not ref.grad_norms:
        return []
    med = statistics.median(ref.grad_norms.values())
    return sorted(n for n, g in ref.grad_norms.items()
                  if g < EXCLUDE_BELOW * med)


def judge(numbers: dict[str, float], limits: dict,
          at_least: dict | None = None) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"} or {"value", "at_least"}})
    against the cell's limits."""
    table = {}
    ok = True
    for name, lim in limits.items():
        value = numbers.get(name, math.inf)
        table[name] = {"value": value, "limit": lim}
        ok = ok and math.isfinite(value) and value <= lim
    for name, least in (at_least or {}).items():
        value = numbers.get(name, 0)
        table[name] = {"value": value, "at_least": least}
        ok = ok and value >= least
    return ok, table
