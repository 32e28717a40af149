"""openeat_torch/quality/report.py's `draws` table and its exact
permutation chance, on synthetic run directories: each run a
metrics.jsonl of epoch records, a results.json with the greedy and
rescoring CERs and a stages.log with stage 8's gate line, beside a
synthetic r5 whose train loss is 20.0 in every epoch.

- Six draws, three from each initializer, whose alignment epochs split
  perfectly (the port's all later) give 1/20 over the C(6,3) splits;
  identical draws give 1; a tie between the groups counts against the
  claim (10/20 where strict counting would give 0).
- A run whose stage 8 did not run gives no draw's row.
"""

from __future__ import annotations

import json
from fractions import Fraction

import pytest

from openeat_torch.quality import report

R5_LOSS = 20.0


def _run(root, name: str, gap: float, aligned: int,
         gate: str | None = "QUALITY_GATE PASS", margin: float = -0.3):
    """A run directory named `name`: train loss R5_LOSS + gap in every
    epoch, train_acc past 0.6 first at `aligned`, and its gate line
    (None: no stage 8)."""
    run = root / name
    run.mkdir()
    with open(run / "metrics.jsonl", "w") as f:
        for e in range(10):
            f.write(json.dumps({"kind": "epoch", "epoch": e,
                                "train_loss": R5_LOSS + gap,
                                "train_acc": 0.7 if e >= aligned else 0.4})
                    + "\n")
    (run / "results.json").write_text(json.dumps(
        {"ctc_greedy_search": 14.0, "attention_rescoring": 14.0 + margin}))
    lines = ["### stage 8 start 0.0"]
    if gate is not None:
        lines.append(gate)
    (run / "stages.log").write_text("\n".join(lines) + "\n")
    return str(run)


@pytest.fixture()
def r5(tmp_path):
    ref = tmp_path / "r5"
    ref.mkdir()
    with open(ref / "metrics.jsonl", "w") as f:
        for e in range(10):
            f.write(json.dumps({"kind": "epoch", "epoch": e,
                                "train_loss": R5_LOSS,
                                "train_acc": 0.7 if e >= 7 else 0.4})
                    + "\n")
    return str(ref)


def _pool(tmp_path, port: list[tuple[float, int]],
          flax: list[tuple[float, int]]):
    """Runs run_draw77x for the port's (gap, aligned) pairs and
    run_flax77x for flax's; returns (runs, names)."""
    runs = [_run(tmp_path, f"run_draw{777 + i}", g, a)
            for i, (g, a) in enumerate(port)]
    runs += [_run(tmp_path, f"run_flax{777 + i}", g, a)
             for i, (g, a) in enumerate(flax)]
    return runs, [r.rsplit("/", 1)[-1] for r in runs]


def _chances(lines: list[str]) -> list[str]:
    return [x for x in lines if x.startswith("- ")]


def test_perfect_separation_gives_one_in_twenty(tmp_path, r5):
    runs, names = _pool(tmp_path, [(0.8, 8), (0.4, 8), (0.2, 8)],
                        [(0.1, 7), (0.0, 7), (-0.1, 7)])
    lines = report.draws(runs, names, ref=r5)
    assert "C(6,3) = 20 splits" in "\n".join(lines)
    assert _chances(lines) == [
        "- mean gap in epochs 2-5 (port above flax): 1/20 = 0.050",
        "- alignment epoch (port later than flax): 1/20 = 0.050"]
    assert report.permutation_chance([8, 8, 8], [7, 7, 7]) \
        == Fraction(1, 20)


def test_identical_groups_give_one(tmp_path, r5):
    runs, names = _pool(tmp_path, [(0.3, 8)] * 3, [(0.3, 8)] * 3)
    lines = report.draws(runs, names, ref=r5)
    assert _chances(lines) == [
        "- mean gap in epochs 2-5 (port above flax): 20/20 = 1.000",
        "- alignment epoch (port later than flax): 20/20 = 1.000"]


def test_ties_count_against_the_claim(tmp_path, r5):
    """Port 8, 8, 8 against flax 7, 8, 8: the 10 splits that put the 7
    in flax's group all tie the observed difference of 1/3, and each
    counts as at least as extreme."""
    assert report.permutation_chance([8, 8, 8], [7, 8, 8]) \
        == Fraction(10, 20)
    runs, names = _pool(tmp_path, [(0.5, 8)] * 3,
                        [(0.1, 7), (0.5, 8), (0.5, 8)])
    lines = report.draws(runs, names, ref=r5)
    assert _chances(lines)[1] == \
        "- alignment epoch (port later than flax): 10/20 = 0.500"


def test_rows_give_gap_alignment_and_gate(tmp_path, r5):
    run = _run(tmp_path, "run_flax778", 0.25, 7,
               gate="QUALITY_GATE FAIL: rescoring 14.00 - greedy 14.10 "
                    "= -0.10 > -0.2 (rescoring must help)", margin=-0.1)
    row = report.draw_row(run, "run_flax778", ref=r5)
    assert (row["init"], row["seed"], row["aligned"], row["gate"]) \
        == ("flax", 778, 7, "FAIL")
    assert row["gaps"] == pytest.approx([0.25] * 4)
    assert row["margin"] == pytest.approx(-0.1)
    assert report.draw_of("run_a") == ("port", 777)
    assert report.draw_of("run_b") is None


def test_run_without_stage_8_is_refused(tmp_path, r5):
    run = _run(tmp_path, "run_draw778", 0.4, 8, gate=None)
    with pytest.raises(ValueError, match="stage 8 did not run"):
        report.draw_row(run, "run_draw778", ref=r5)
    flax = _run(tmp_path, "run_flax778", 0.1, 7)
    with pytest.raises(ValueError, match="stage 8 did not run"):
        report.draws([flax, run], ["run_flax778", "run_draw778"], ref=r5)
