"""openeat_torch/utils/profiling.py and the trainer's --profile_dir, on
the CPU.

- trace(dir) writes a Chrome trace (JSON with traceEvents) that names
  the ops and the span() run inside it, and the region a kernel wrapper
  opens around its launch (ops/nvcc.py:launch_region, named after the C
  entry point);
- span() and launch_region off (no profiler) are one shared nullcontext
  that builds no region; under a profiler nested spans are regions
  nested on its clock, with the ops they ran inside them;
- PrefetchLoader waits once a batch, apply_update reads the norm in a
  sync span inside its update span, applied or skipped;
- one epoch of bin.train with accum_grad 2 under a profiler gives an
  openeat.step an update with two forwards, two backwards and one
  update holding one sync, a wait and a feed a batch, all on the
  stepping thread, and the same epoch_1.pt, bit for bit, as a run
  without the profiler;
- bin.train --device cpu --profile_dir on the tiny corpus writes a trace
  of its warm steps that names the train step's spans, and then the same
  epoch_1.pt, bit for bit, and the same step records as a run without
  the flag: the port restores the model, the optimizer and the counts
  after its traced steps (the JAX trainer keeps their updates).
"""

import collections
import contextlib
import glob
import json
import os

import pytest
import torch

from openeat_torch.bin import train
from openeat_torch.dataset.dataset import PrefetchLoader
from openeat_torch.ops import nvcc
from openeat_torch.parallel.train_step import TrainState, apply_update
from openeat_torch.utils import profiling
from tests._torch_parity import TINY_CONF
from tests.make_tiny_data import build as build_tiny

torch.set_num_threads(1)

STEP_SPANS = {"openeat.step.forward", "openeat.step.backward",
              "openeat.step.update", "openeat.step.sync"}


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    assert isinstance(nvcc.launch_region("openeat_dwconv1d_fwd"),
                      contextlib.nullcontext)
    with profiling.trace(str(tmp_path / "prof"), torch.device("cpu")):
        with profiling.span("openeat.step"):
            y = torch.relu(x @ x)
        with nvcc.launch_region("openeat_dwconv1d_fwd"):
            y = y + 1
    assert y.shape == (64, 64)
    files = glob.glob(str(tmp_path / "prof" / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"openeat.step", "aten::mm", "openeat_dwconv1d_fwd"} <= names


def test_span_off_is_the_shared_nullcontext(monkeypatch):
    def no_region(name, *args):
        raise AssertionError("an off span built a profiler region")

    monkeypatch.setattr(profiling.torch.profiler, "record_function",
                        no_region)
    a, b = profiling.span("openeat.step"), profiling.span("openeat.feed")
    c = nvcc.launch_region("openeat_ctc_dp")
    assert a is b is c is profiling._OFF
    assert isinstance(a, contextlib.nullcontext)
    with a:
        with b:
            pass


def test_spans_under_a_profiler_nest_on_its_clock(tmp_path):
    span = profiling.span
    with profiling.trace(str(tmp_path), torch.device("cpu")) as prof:
        with span("openeat.step"):
            with span("openeat.step.update"):
                with span("openeat.step.sync"):
                    torch.ones(4).sum()
        with span("openeat.loader.wait"):
            pass
    # spans after the profile are off again
    assert profiling.span("openeat.step") is profiling._OFF
    events = {e.name: e for e in prof.events()
              if e.name.startswith("openeat.")}
    assert set(events) == {"openeat.step", "openeat.step.update",
                           "openeat.step.sync", "openeat.loader.wait"}
    parent = {n: e.cpu_parent and e.cpu_parent.name
              for n, e in events.items()}
    assert parent == {"openeat.step": None,
                      "openeat.step.update": "openeat.step",
                      "openeat.step.sync": "openeat.step.update",
                      "openeat.loader.wait": None}
    step, sync = events["openeat.step"], events["openeat.step.sync"]
    assert (step.time_range.start <= sync.time_range.start
            <= sync.time_range.end <= step.time_range.end)
    assert events["openeat.loader.wait"].time_range.start \
        >= step.time_range.end
    assert any(c.name == "aten::sum" for c in sync.cpu_children)


def span_counts(prof) -> collections.Counter:
    return collections.Counter(e.name for e in prof.events()
                               if e.name.startswith("openeat."))


@pytest.mark.parametrize("workers,prefetch,n", [(1, 1, 5), (2, 4, 3),
                                                (4, 2, 9)])
def test_loader_waits_once_a_batch(workers, prefetch, n, tmp_path):
    """PrefetchLoader yields every batch, in order, and opens one
    openeat.loader.wait a batch on the thread that iterates it."""
    loader = PrefetchLoader(list(range(n)), lambda x: (x, 10 * x),
                            num_workers=workers, prefetch=prefetch)
    with profiling.trace(str(tmp_path), torch.device("cpu")) as prof:
        got = list(loader)
    assert got == [(i, 10 * i) for i in range(n)]
    assert span_counts(prof) == {"openeat.loader.wait": n}
    assert list(loader) == got   # off: the same batches


@pytest.mark.parametrize("grad", [1.0, float("nan")])
def test_apply_update_reads_the_norm_inside_its_span(grad, tmp_path):
    """apply_update is one openeat.step.update with the norm's read,
    openeat.step.sync, inside it, whether or not the step is applied."""
    model = torch.nn.Linear(3, 2)
    state = TrainState(model, torch.optim.Adam(model.parameters(), 0.1))
    model.weight.grad = torch.full_like(model.weight, grad)
    with profiling.trace(str(tmp_path), torch.device("cpu")) as prof:
        _, applied = apply_update(state, lambda n: 0.1, grad_clip=5.0)
    assert applied == (grad == 1.0)
    assert (state.step, state.n_applied) == (1, int(applied))
    assert span_counts(prof) == {"openeat.step.update": 1,
                                 "openeat.step.sync": 1}
    sync, = [e for e in prof.events() if e.name == "openeat.step.sync"]
    assert sync.cpu_parent.name == "openeat.step.update"


def tiny_run_config(tmp_path, **extra) -> tuple[dict, str]:
    data = build_tiny(str(tmp_path), n_utts=6, seed=7, max_dur=1.2)
    cfg = {"model_conf": dict(TINY_CONF, dropout_rate=0.1),
           "collate_conf": {"spec_aug": True},
           "dataset_conf": {"batch_type": "dynamic",
                            "max_frames_in_batch": 400},
           "optim_conf": {"lr": 0.002}, "warmup_steps": 2,
           "log_interval": 1, "seed": 13, **extra}
    cfg_path = str(tmp_path / "train.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    return data, cfg_path


def train_once(tmp_path, data, cfg_path, name, extra=()):
    """bin.train for one epoch: (state, epoch_1.pt, the train records)."""
    exp = tmp_path / name
    state = train.main(["--config", cfg_path, "--train_data",
                        data["manifest"], "--cv_data", data["manifest"],
                        "--dict", data["dict"], "--exp_dir", str(exp),
                        "--device", "cpu", "--num_workers", "1",
                        "--max_epoch", "1", *extra])
    with open(exp / "metrics.jsonl") as f:
        steps = [{k: v for k, v in json.loads(x).items() if k != "time"}
                 for x in f if json.loads(x)["kind"] == "train"]
    return state, torch.load(exp / "epoch_1.pt", weights_only=True), steps


def test_train_epoch_under_a_profiler_gives_its_spans(tmp_path):
    data, cfg_path = tiny_run_config(tmp_path, accum_grad=2)
    with profiling.trace(str(tmp_path / "prof"),
                         torch.device("cpu")) as prof:
        state_p, ckpt_p, steps_p = train_once(tmp_path, data, cfg_path,
                                              "profiled")
    state, ckpt, steps = train_once(tmp_path, data, cfg_path, "plain")
    by_name = collections.defaultdict(list)
    for e in prof.events():
        if e.name.startswith("openeat."):
            by_name[e.name].append(e)
    n = state_p.step
    assert n >= 2
    # one openeat.step an update, two forwards and two backwards in it
    assert len(by_name["openeat.step"]) == n
    for name in ("openeat.step.forward", "openeat.step.backward",
                 "openeat.step.update"):
        assert all(e.cpu_parent.name == "openeat.step"
                   for e in by_name[name]), name
        parents = collections.Counter(id(e.cpu_parent)
                                      for e in by_name[name])
        want = 1 if name == "openeat.step.update" else 2
        assert sorted(parents.values()) == [want] * n, name
    syncs = by_name["openeat.step.sync"]
    assert len(syncs) == n
    assert all(e.cpu_parent.name == "openeat.step.update" for e in syncs)
    # the train loader's and the cv loader's batches: a wait and a feed
    # each, outside the step
    waits, feeds = by_name["openeat.loader.wait"], by_name["openeat.feed"]
    assert len(waits) == len(feeds) >= n
    assert all(e.cpu_parent is None for e in waits + feeds)
    # all of them on the stepping thread
    assert len({e.thread for es in by_name.values() for e in es}) == 1
    # the profiler changes nothing the run computes
    assert (state_p.step, state_p.n_applied) == (state.step, state.n_applied)
    assert steps_p == steps
    assert set(ckpt_p) == set(ckpt)
    for k in ckpt:
        assert torch.equal(ckpt_p[k], ckpt[k]), k


def test_train_profile_dir_writes_a_trace_and_the_same_checkpoint(
        tmp_path):
    data, cfg_path = tiny_run_config(tmp_path)
    prof = str(tmp_path / "prof")
    state_p, ckpt_p, steps_p = train_once(tmp_path, data, cfg_path,
                                          "profiled",
                                          ["--profile_dir", prof])
    state, ckpt, steps = train_once(tmp_path, data, cfg_path, "plain")
    files = glob.glob(os.path.join(prof, "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert STEP_SPANS <= names
    assert (state_p.step, state_p.n_applied) == (state.step, state.n_applied)
    assert steps_p == steps
    assert set(ckpt_p) == set(ckpt)
    for k in ckpt:
        assert torch.equal(ckpt_p[k], ckpt[k]), k
