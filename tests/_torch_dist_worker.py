"""One rank of the gloo jobs of tests/test_torch_parallel.py,
tests/test_torch_pipeline.py and tests/test_torch_sequence_parallel.py.

    python -m tests._torch_dist_worker WORKDIR

with RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and
MASTER_PORT set, as torchrun sets them. It imports torch and the port
only (no JAX), reads WORKDIR/tasks.json and runs the tasks in order,
each on a port of its own that the first rank takes from the system
just before the task and hands to the others in WORKDIR/port.<index>,
so that a task's process group never meets the last one's, nor another
job's (a fixed run of ports after MASTER_PORT would meet the gloo
sockets of jobs running beside it). The first rank writes each task's
results to WORKDIR/<name>.pt; a task that looks at every rank writes
WORKDIR/<name>.<rank>.pt. A task that raises ends the job with the
traceback on stderr. Every task records the shapes of the inputs that
reach K3 (the conv module's depthwise_conv1d) on its rank.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import sys
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

import openeat_torch.modules.convolution as conv_mod
import openeat_torch.modules.encoder as encoder_mod
from openeat_torch.bin import recognize, train, train_lm
from openeat_torch.dataset.dataset import (AudioCollate, AudioDataset,
                                           PrefetchLoader)
from openeat_torch.dataset.text import load_dict
from openeat_torch.models.asr_model import build_asr_model
from openeat_torch.modules.dropout import Dropout
from openeat_torch.ops.frontend import FrontendConfig
from openeat_torch.parallel import tensor_parallel as tp
from openeat_torch.parallel.mesh import (apply_mesh, full_optimizer_state,
                                         full_state_dict, make_mesh,
                                         make_pipe_mesh)
from openeat_torch.parallel.pipeline import make_pp_loss_fn
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


K3_SHAPES: list = []


def _record_k3() -> None:
    """Keep the shape of every input that reaches K3 (the plain version
    on the CPU) in K3_SHAPES."""
    run = conv_mod.depthwise_conv1d

    def recorded(x, w):
        K3_SHAPES.append(tuple(x.shape))
        return run(x, w)
    conv_mod.depthwise_conv1d = recorded


def _rows(task: dict, mesh) -> dict:
    """This rank's rows of the task's batch padded to a multiple of dp."""
    with np.load(task["batch"]) as z:
        batch = pad_rows(dict(z), mesh.dp)
    rows = mesh.rows(len(batch["features"]))
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
            for k, v in batch.items()}


def step(task: dict, workdir: str) -> None:
    """One SGD step of the train step at (dp, tp) on the global batch
    padded to a multiple of dp, this rank's rows; the first rank writes
    the metrics and the gathered parameters (and, with "encode", the
    encoder's output on the rank's rows before the step). Each rank
    writes its shards and the K3 input shapes of its step."""
    _init_group()
    try:
        mesh = make_mesh(task["dp"], task["tp"])
        model = _model(task)
        apply_mesh(model, mesh)
        batch = _rows(task, mesh)
        enc = None
        if task.get("encode"):
            with torch.no_grad():
                enc = model.encode(batch["features"],
                                   batch["features_length"].long())[0]
        opt, schedule = build_optimizer(model, task["lr"], 1, "sgd")
        state = TrainState(model, opt)
        K3_SHAPES.clear()
        metrics = build_train_step(schedule, 1, 5.0, mesh=mesh)(
            state, batch, None)
        shards = {n: p.detach().clone() for n, p in model.named_parameters()
                  if hasattr(p, "tp_dim")}
        params = full_state_dict(model, mesh)
        torch.save({"shards": shards, "k3": list(K3_SHAPES)},
                   os.path.join(workdir, f"{task['name']}.{RANK}.pt"))
        if RANK == 0:
            torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                        "params": params, "encoder_out": enc,
                        "plan": {n: p.tp_dim for n, p in
                                 model.named_parameters()
                                 if hasattr(p, "tp_dim")}},
                       os.path.join(workdir, f"{task['name']}.pt"))
    finally:
        dist.destroy_process_group()


def pp(task: dict, workdir: str) -> None:
    """The pipelined loss at (dp, pp) with num_micro microbatches, on
    this rank's rows. "grads": one backward; each rank writes its
    metrics, its parameters' gradients, the layers it holds and its
    parameter bytes. "step": one step of build_train_step (task["optim"]
    at task["lr"], clip 5); the first rank writes the metrics, the
    gathered parameters and optimizer state."""
    _init_group()
    try:
        mesh = make_pipe_mesh(task["dp"], task["pp"])
        model = _model(task)
        apply_mesh(model, mesh)
        batch = _rows(task, mesh)
        loss_fn = make_pp_loss_fn(model, mesh, task["num_micro"],
                                  task.get("tail", False))
        out = {"held": sorted({n.split(".")[2] for n, _ in
                               model.named_parameters()
                               if n.startswith("encoder.encoders.layer_")}),
               "param_bytes": sum(p.numel() * p.element_size()
                                  for p in model.parameters())}
        K3_SHAPES.clear()
        if task["mode"] == "grads":
            model.train()
            metrics = loss_fn(model, batch)
            metrics["loss"].backward()
            out["metrics"] = {k: float(v) for k, v in metrics.items()}
            out["grads"] = {n: p.grad.detach().clone()
                            for n, p in model.named_parameters()
                            if p.grad is not None}
        else:
            opt, schedule = build_optimizer(model, task["lr"], 1,
                                            task["optim"])
            metrics = build_train_step(schedule, 1, 5.0, loss_fn=loss_fn,
                                       mesh=mesh)(TrainState(model, opt),
                                                  batch, None)
            out["metrics"] = {k: float(v) for k, v in metrics.items()}
            params = full_state_dict(model, mesh)
            opt_state = full_optimizer_state(opt, mesh, model)
            if RANK == 0:
                out.update(params=params, optimizer=opt_state)
        out["k3"] = list(K3_SHAPES)
        torch.save(out, os.path.join(workdir, f"{task['name']}.{RANK}.pt"))
    finally:
        dist.destroy_process_group()


def halo(task: dict, workdir: str) -> None:
    """halo_exchange at tp = 2 against F.pad over the whole time, both
    ways, for the symmetric and the causal conv's padding."""
    _init_group()
    try:
        mesh = make_mesh(1, 2)
        sp = tp.TimeShard(mesh.model_group, 2, mesh.model_rank)
        out = {}
        for left, right in task["pads"]:
            rng = np.random.default_rng(left * 10 + right)
            t = 16
            x = torch.from_numpy(rng.standard_normal((3, 2 * t, 5)).astype(
                np.float32)).requires_grad_()
            gs = [torch.from_numpy(rng.standard_normal(
                (3, t + left + right, 5)).astype(np.float32))
                for _ in range(2)]
            mine = sp.local(x.detach()).clone().requires_grad_()
            y = tp.halo_exchange(mine, left, right, sp)
            (y * gs[sp.i]).sum().backward()
            padded = torch.nn.functional.pad(x, (0, 0, left, right))
            ref = sum((padded[:, i * t:i * t + t + left + right] * gs[i])
                      .sum() for i in range(2))
            ref.backward()
            want_y = padded[:, sp.i * t:sp.i * t + t + left + right]
            out[f"{left},{right}"] = (
                float((y - want_y).abs().max()),
                float((mine.grad - sp.local(x.grad)).abs().max()),
                tuple(y.shape))
        torch.save(out, os.path.join(workdir, f"{task['name']}.{RANK}.pt"))
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


@contextlib.contextmanager
def _recording_draws(draws: list):
    """Append to `draws`, for each training step, the dynamic chunk size
    and the next four numbers of the step's dropout generator (the
    uniforms its first mask starts from), without consuming them."""
    make_mask, forward = encoder_mod.dynamic_chunk_mask, Dropout.forward

    def recorded(t, chunk_size, *args):
        draws.append({"chunk": int(chunk_size)})
        return make_mask(t, chunk_size, *args)

    def first_mask(self, x, shard=None):
        if self.training and draws and "next" not in draws[-1]:
            g = torch.Generator().set_state(self.generator.get_state())
            draws[-1]["next"] = torch.rand(4, generator=g).tolist()
        return forward(self, x, shard)

    encoder_mod.dynamic_chunk_mask, Dropout.forward = recorded, first_mask
    try:
        yield
    finally:
        encoder_mod.dynamic_chunk_mask, Dropout.forward = make_mask, forward


def cli(task: dict, workdir: str) -> None:
    """An entry point under the torchrun environment; with "raises", the
    message of the exception it must raise; with "draws", the chunk
    sizes and dropout draws of its training steps."""
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
        draws = []
        K3_SHAPES.clear()
        with (_recording_draws(draws) if task.get("draws")
              else contextlib.nullcontext()):
            state = main(task["argv"])
        if state is not None:
            shards = {n: p.detach().clone()
                      for n, p in state.model.named_parameters()
                      if hasattr(p, "tp_dim")}
            torch.save({"shards": shards, "step": state.step,
                        "draws": draws, "k3": sorted(set(K3_SHAPES)),
                        "dims": {n: p.tp_dim for n, p in
                                 state.model.named_parameters()
                                 if hasattr(p, "tp_dim")}},
                       os.path.join(workdir, f"{task['name']}.{RANK}.pt"))
    finally:
        os.environ.clear()
        os.environ.update(env)


TASKS = {"step": step, "pp": pp, "halo": halo, "feeder": feeder,
         "cli": cli}


def _task_port(workdir: str, i: int, timeout: float = 120.0) -> str:
    """Task i's port: a free one the first rank picks, the others read."""
    path = os.path.join(workdir, f"port.{i}")
    if RANK == 0:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = str(sock.getsockname()[1])
        with open(path + ".tmp", "w") as f:
            f.write(port)
        os.replace(path + ".tmp", path)
        return port
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.02)
    with open(path) as f:
        return f.read()


def main(workdir: str) -> None:
    _record_k3()
    with open(os.path.join(workdir, "tasks.json")) as f:
        tasks = json.load(f)
    for i, task in enumerate(tasks):
        os.environ["MASTER_PORT"] = _task_port(workdir, i)
        TASKS[task["kind"]](task, workdir)


if __name__ == "__main__":
    main(sys.argv[1])
