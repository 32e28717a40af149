"""openeat_torch/utils/profiling.py and the trainer's --profile_dir, on
the CPU.

- trace(dir) writes a Chrome trace (JSON with traceEvents) that names
  the ops and the annotate() region run inside it, and the region a
  kernel wrapper opens around its launch (ops/nvcc.py:launch_region,
  named after the C entry point), which is no region outside a
  profiler;
- StepTimer's counters on a scripted clock equal the JAX package's
  StepTimer's (step time, audio seconds per second per chip, their
  EMAs), and n_chips is 1 outside a process group;
- bin.train --device cpu --profile_dir on the tiny corpus writes a trace
  of its warm steps and then the same epoch_1.pt, bit for bit, and the
  same step records as a run without the flag: the port restores the
  model, the optimizer and the counts after its traced steps (the JAX
  trainer keeps their updates).
"""

import contextlib
import glob
import json
import os

import pytest
import torch

from openeat_tpu.utils import profiling as jax_profiling
from openeat_torch.bin import train
from openeat_torch.ops import nvcc
from openeat_torch.utils import profiling
from tests._torch_parity import TINY_CONF
from tests.make_tiny_data import build as build_tiny

torch.set_num_threads(1)


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    assert isinstance(nvcc.launch_region("openeat_dwconv1d_fwd"),
                      contextlib.nullcontext)
    with profiling.trace(str(tmp_path / "prof"), torch.device("cpu")):
        with profiling.annotate("openeat_step"):
            y = torch.relu(x @ x)
        with nvcc.launch_region("openeat_dwconv1d_fwd"):
            y = y + 1
    assert y.shape == (64, 64)
    files = glob.glob(str(tmp_path / "prof" / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"openeat_step", "aten::mm", "openeat_dwconv1d_fwd"} <= names


def test_step_timer_counters_equal_jax(monkeypatch):
    times = [10.0, 10.5, 11.25, 11.75, 13.0]
    frames = [0, 800, 1200, 400, 2000]
    got, want = [], []
    for module, out in ((profiling, got), (jax_profiling, want)):
        ticks = iter(times)
        monkeypatch.setattr(module.time, "perf_counter",
                            lambda ticks=ticks: next(ticks))
        timer = module.StepTimer(ema=0.9, n_chips=2)
        out.extend(timer.tick(n) for n in frames)
        assert timer.steps == len(frames)
    assert got == want
    assert got[0] == {} and got[1]["step_time_s"] == 0.5
    assert got[1]["audio_sec_per_sec_per_chip"] == pytest.approx(8.0)
    assert profiling.StepTimer().n_chips == 1


def test_train_profile_dir_writes_a_trace_and_the_same_checkpoint(
        tmp_path):
    data = build_tiny(str(tmp_path), n_utts=6, seed=7, max_dur=1.2)
    cfg = {"model_conf": dict(TINY_CONF, dropout_rate=0.1),
           "collate_conf": {"spec_aug": True},
           "dataset_conf": {"batch_type": "dynamic",
                            "max_frames_in_batch": 400},
           "optim_conf": {"lr": 0.002}, "warmup_steps": 2,
           "log_interval": 1, "seed": 13}
    cfg_path = str(tmp_path / "train.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)

    def run(name, extra=()):
        exp = tmp_path / name
        state = train.main(["--config", cfg_path, "--train_data",
                            data["manifest"], "--cv_data", data["manifest"],
                            "--dict", data["dict"], "--exp_dir", str(exp),
                            "--device", "cpu", "--num_workers", "1",
                            "--max_epoch", "1", *extra])
        with open(exp / "metrics.jsonl") as f:
            steps = [{k: v for k, v in json.loads(x).items() if k != "time"}
                     for x in f if json.loads(x)["kind"] == "train"]
        return state, torch.load(exp / "epoch_1.pt", weights_only=True), \
            steps

    prof = str(tmp_path / "prof")
    state_p, ckpt_p, steps_p = run("profiled", ["--profile_dir", prof])
    state, ckpt, steps = run("plain")
    assert len(glob.glob(os.path.join(prof, "trace_*.json"))) == 1
    assert (state_p.step, state_p.n_applied) == (state.step, state.n_applied)
    assert steps_p == steps
    assert set(ckpt_p) == set(ckpt)
    for k in ckpt:
        assert torch.equal(ckpt_p[k], ckpt[k]), k
