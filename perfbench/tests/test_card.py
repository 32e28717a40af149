"""On the card, at the cells' own sizes: the control fails each training
cell's limits on three seeds, and a short run is correct. Skips without
a card."""

import time

import pytest

from perfbench import check, run, spec
from perfbench.calibrate import readings

CELLS = ["aishell_train_bf16", "librispeech_train_bf16"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_three_seeds(name, card):
    """The control and the half-batch fault fail the cell's limits; the
    program passes them, with K1 and K2 launched in its checked
    updates."""
    cell = spec.load_cell(name)
    limits, least = cell.limits["limits"], cell.limits["at_least"]
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        row = readings(cell, seed, True, card)
        ok, table = check.judge(row["control_fp8"], limits)
        assert not ok, (seed, table)
        ok, table = check.judge(row["fault_half_batch"], limits)
        assert not ok, (seed, table)
        ok, table = check.judge({**row["program"], **row["launches"]},
                                limits, least)
        assert ok, (seed, table)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_short_run_is_correct(name, card):
    cell = spec.load_cell(name)
    res = run.run_cell(cell, 2 ** 31 + 21, 5.0, False, card,
                       time.perf_counter())
    assert res["correct"] is True, res["check"]
    assert res["device"]["platform"] == "gpu"
