"""The check fails a broken timed path. Each fault is planted in the
program underneath a whole run at a tiny size on the CPU (the run skips
its look for a card); the cell's own limits judge it."""

import time

import torch

import openeat_torch.parallel.train_step as train_step
from perfbench import check, run
from perfbench.kinds.train import TrainRun
from perfbench.reference.conformer import Precision
from perfbench.tests.tiny import tiny_cell


def broken_run(tmp_path, mix="aishell_train"):
    cell = tiny_cell(traffic=mix)
    return run.run_cell(cell, 41, 1.0, False, torch.device("cpu"),
                        time.perf_counter(), cache_root=tmp_path)


def test_step_that_leaves_the_state_unchanged(monkeypatch, tmp_path):
    def unchanged(state, schedule, grad_clip, mesh=None):
        state.step += 1
        return torch.zeros(()), True
    monkeypatch.setattr(train_step, "apply_update", unchanged)
    res = broken_run(tmp_path)
    assert res["correct"] is False
    assert res["check"]["delta_gap"]["value"] >= 0.99


def test_half_the_batch_left_out(monkeypatch, tmp_path):
    whole = train_step.asr_loss

    def half(model, batch):
        k = max(1, batch["features"].shape[0] // 2)
        return whole(model, {key: v[:k] for key, v in batch.items()})
    monkeypatch.setattr(train_step, "asr_loss", half)
    for mix in ("aishell_train", "librispeech_train"):
        res = broken_run(tmp_path, mix)
        assert res["correct"] is False, (mix, res["check"])


def test_control_reads_far_above_the_program_at_a_tiny_size(tmp_path):
    """The reference computed in float8, put in the program's place,
    reads the first gradient's worst leaf several times further from the
    reference than the program in bfloat16 does (the cell's own limits
    are set at its own size, on the card: test_card.py)."""
    cell = tiny_cell()
    tr = TrainRun(cell, 43, torch.device("cpu"), tmp_path)
    mine = tr.program_check()
    tr.free_program()
    ref = tr.reference(Precision())
    fp8 = tr.reference(Precision(fp8=True))
    program = check.compare(mine, ref)
    control = check.compare(fp8, ref)
    assert control["grad_gap"] > 5 * program["grad_gap"], (program, control)


def test_the_check_refuses_batches_it_did_not_follow(tmp_path):
    """Where the reference's batches are not the ones the program took,
    no number is read and the run is not correct."""
    cell = tiny_cell(traffic="librispeech_train")
    tr = TrainRun(cell, 47, torch.device("cpu"), tmp_path)
    mine = tr.program_check()
    tr.free_program()
    tr.check_idx = tr.check_idx[1:] + tr.check_idx[:1]
    numbers = check.compare(mine, tr.reference(Precision()))
    ok, _ = check.judge(numbers, cell.limits["limits"])
    assert not ok and all(v == float("inf") for v in numbers.values())


def test_a_check_without_a_cluster_kernel_launch_is_refused():
    limits = {"grad_gap": 0.08}
    least = {"ctc_shared_launches": 1, "ctc_global_launches": 1}
    ok, table = check.judge({"grad_gap": 0.01, "ctc_shared_launches": 3,
                             "ctc_global_launches": 0}, limits, least)
    assert not ok and table["ctc_global_launches"] == {"value": 0,
                                                       "at_least": 1}
    ok, _ = check.judge({"grad_gap": 0.01, "ctc_shared_launches": 3,
                         "ctc_global_launches": 2}, limits, least)
    assert ok
