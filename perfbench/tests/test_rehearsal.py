"""A CPU rehearsal of each training mix at a tiny size: the program's
loader, batching, transcripts, feeder, Executor and train step drive a
run end to end (the runner itself refuses the CPU), and the reference
follows its first updates."""

import math
import time
from pathlib import Path

import pytest
import torch

from perfbench import run
from perfbench.tests.tiny import tiny_cell

MIXES = ["aishell_train", "librispeech_train"]


def rehearse(mix, seed, tracing=False, dtype=None, cache=None):
    cell = tiny_cell(traffic=mix)
    if dtype:
        cell.config["model_conf"]["compute_dtype"] = dtype
    return cell, run.run_cell(cell, seed, 1.0, tracing, torch.device("cpu"),
                              time.perf_counter(), cache_root=cache)


@pytest.mark.parametrize("mix", MIXES)
def test_run_end_to_end(mix, tmp_path):
    cell, res = rehearse(mix, 2 ** 31 + 99, cache=tmp_path)
    assert res["correct"] is True, res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert res["metrics"]["train_audio_s_per_s"]["value"] > 0
    notes = res["notes"]
    assert notes["updates"] == res["attempted"]
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("mix", MIXES)
def test_traced_run_reads_its_layers(mix, tmp_path):
    cell, res = rehearse(mix, 5, tracing=True, cache=tmp_path)
    got = set(res["metrics"])
    # the device metrics have nothing to read on the CPU
    assert {"train.input_wait_ms", "train.fwd_bwd_ms",
            "train.update_ms"} <= got
    assert not got & {"k3_roofline.train", "ctc_roofline.train",
                      "train.mfu"}
    assert res["device"]["window_s"] > 0
    assert len(res["breakdown"]["idle_gaps"]) <= 10


@pytest.mark.parametrize("mix", MIXES)
def test_reference_follows_the_program_exactly_in_float32(mix, tmp_path):
    """With the program in float32 the two sides differ by rounding
    alone: the batches, rows, padding, features, SpecAugment spans and
    dropout masks are the same on both. The change over three Adam
    steps reads a little wider: on an element whose gradient crosses zero
    between updates (one LayerNorm weight's, at seed 777) Adam's ratio
    turns float32 rounding into a few percent of that element's step."""
    _, res = rehearse(mix, 777, dtype="float32", cache=tmp_path)
    gaps = res["notes"]["numbers"]
    assert gaps["loss_gap"] < 1e-5, gaps
    assert gaps["grad_gap"] < 1e-3, gaps
    assert gaps["delta_gap"] < 3e-3, gaps
    assert all(math.isfinite(v) for v in gaps.values())


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert run.main(["--workload", "aishell_train_bf16", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_tree_without_the_program_fails(tmp_path):
    """In a directory with BENCHMARK.json and perfbench/ only, a run
    prints no result and exits non-zero."""
    import shutil
    import subprocess
    import sys
    from perfbench import spec
    shutil.copytree(spec.PACKAGE_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                          "aishell_train_bf16", "--seed", "3", "--seconds",
                          "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert Path(tmp_path / "perfbench").is_dir()
