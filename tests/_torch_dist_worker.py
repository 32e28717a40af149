"""One rank of the two-rank gloo jobs of tests/test_torch_parallel.py.

    python -m tests._torch_dist_worker WORKDIR

with RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and
MASTER_PORT set, as torchrun sets them. It imports torch and the port
only (no JAX), reads WORKDIR/tasks.json and runs the tasks in order,
each on its own port (MASTER_PORT + its index) so that a task's process
group never meets the last one's. The first rank writes each task's
results to WORKDIR/<name>.pt; a task that looks at every rank writes
WORKDIR/<name>.<rank>.pt. A task that raises ends the job with the
traceback on stderr.
"""

from __future__ import annotations

import json
import os
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from openeat_torch.bin import recognize, train, train_lm
from openeat_torch.dataset.dataset import (AudioCollate, AudioDataset,
                                           PrefetchLoader)
from openeat_torch.dataset.text import load_dict
from openeat_torch.models.asr_model import build_asr_model
from openeat_torch.ops.frontend import FrontendConfig
from openeat_torch.parallel.mesh import (apply_mesh, full_state_dict,
                                         make_mesh)
from openeat_torch.parallel.train_step import TrainState, build_train_step
from openeat_torch.pipeline import DeviceFeeder, pad_rows
from openeat_torch.utils.optim import build_optimizer
from openeat_torch.utils.param_bridge import flax_to_state_dict

torch.set_num_threads(1)
RANK = int(os.environ.get("RANK", 0))


def _init_group():
    dist.init_process_group("gloo", rank=RANK,
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=timedelta(seconds=120))


def _model(task: dict):
    model = build_asr_model(task["conf"], task["feat_dim"], task["vocab"])
    with np.load(task["leaves"]) as z:
        model.load_state_dict(flax_to_state_dict(dict(z), model))
    return model


def step(task: dict, workdir: str) -> None:
    """One SGD step of the train step at (dp, tp) on the global batch
    padded to a multiple of dp, this rank's rows; the first rank writes
    the metrics and the gathered parameters."""
    _init_group()
    try:
        mesh = make_mesh(task["dp"], task["tp"])
        model = _model(task)
        apply_mesh(model, mesh)
        with np.load(task["batch"]) as z:
            batch = pad_rows(dict(z), mesh.dp)
        rows = mesh.rows(len(batch["features"]))
        batch = {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
                 for k, v in batch.items()}
        opt, schedule = build_optimizer(model, task["lr"], 1, "sgd")
        state = TrainState(model, opt)
        metrics = build_train_step(schedule, 1, 5.0, mesh=mesh)(
            state, batch, None)
        shards = {n: p.detach().clone() for n, p in model.named_parameters()
                  if hasattr(p, "tp_dim")}
        params = full_state_dict(model, mesh)
        torch.save({"shards": shards}, os.path.join(
            workdir, f"{task['name']}.{RANK}.pt"))
        if RANK == 0:
            torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                        "params": params,
                        "plan": {n: p.tp_dim for n, p in
                                 model.named_parameters()
                                 if hasattr(p, "tp_dim")}},
                       os.path.join(workdir, f"{task['name']}.pt"))
    finally:
        dist.destroy_process_group()


def feeder(task: dict, workdir: str) -> None:
    """This rank's features of each batch from the training feeder at
    dp = 2 (dither, spec-sub and SpecAugment on) against its rows of
    the single-process feeder's."""
    _init_group()
    try:
        mesh = make_mesh(2, 1)
        ds = AudioDataset(task["manifest"], load_dict(task["dict"]),
                          batch_size=3, batch_type="static")
        fe = FrontendConfig(feature_dither=0.1, spec_sub=True, spec_aug=True)
        runs = [DeviceFeeder(PrefetchLoader(ds, AudioCollate(), 1), fe,
                             torch.device("cpu"), pad_batch_multiple=2,
                             train=True, seed=5, **kw)
                for kw in ({"mesh": mesh}, {})]
        errs = []
        for (_, mine), (_, whole) in zip(*runs):
            whole = {k: v.numpy() for k, v in whole.items()}
            rows = mesh.rows(len(whole["features"]))
            errs.append(max(float(np.abs(mine[k].numpy()
                                         - whole[k][rows]).max())
                            for k in mine))
        torch.save({"errors": errs, "rows": (rows.start, rows.stop)},
                   os.path.join(workdir, f"{task['name']}.{RANK}.pt"))
    finally:
        dist.destroy_process_group()


def cli(task: dict, workdir: str) -> None:
    """An entry point under the torchrun environment; with "raises", the
    message of the exception it must raise."""
    main = {"recognize": recognize.main, "train": train.main,
            "train_lm": train_lm.main}[task["cli"]]
    env = dict(os.environ)
    os.environ.update(task.get("env", {}))
    try:
        if "raises" in task:
            try:
                main(task["argv"])
            except ValueError as e:
                msg = str(e)
            else:
                msg = None
            torch.save({"message": msg}, os.path.join(
                workdir, f"{task['name']}.{RANK}.pt"))
            return
        state = main(task["argv"])
        if state is not None:
            shards = {n: p.detach().clone()
                      for n, p in state.model.named_parameters()
                      if hasattr(p, "tp_dim")}
            torch.save({"shards": shards, "step": state.step,
                        "dims": {n: p.tp_dim for n, p in
                                 state.model.named_parameters()
                                 if hasattr(p, "tp_dim")}},
                       os.path.join(workdir, f"{task['name']}.{RANK}.pt"))
    finally:
        os.environ.clear()
        os.environ.update(env)


TASKS = {"step": step, "feeder": feeder, "cli": cli}


def main(workdir: str) -> None:
    with open(os.path.join(workdir, "tasks.json")) as f:
        tasks = json.load(f)
    base = int(os.environ["MASTER_PORT"])
    for i, task in enumerate(tasks):
        os.environ["MASTER_PORT"] = str(base + i)
        TASKS[task["kind"]](task, workdir)


if __name__ == "__main__":
    main(sys.argv[1])
