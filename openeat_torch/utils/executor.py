"""Epoch loops. Port of openeat_tpu/utils/executor.py:Executor.

`train` runs one epoch of train steps, keeps the running loss and
accuracy over the steps whose loss is finite, logs every log_interval
steps, and appends records to metrics.jsonl; each step with its running
sums is the span `openeat.step` (utils/profiling.py). `cv` is the
no-grad loop, weighted by batch size. Running sums stay on the device;
the host reads them at log points and at the end.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Callable, Iterable

import torch
import torch.distributed as dist

from openeat_torch.parallel.tensor_parallel import global_count, global_sum
from openeat_torch.parallel.train_step import TrainState
from openeat_torch.utils.profiling import span


class Executor:
    def __init__(self, train_step: Callable, eval_step: Callable,
                 schedule: Callable[[int], float] | None = None,
                 log_interval: int = 100,
                 logger: logging.Logger | None = None,
                 metrics_file: str | None = None, mesh=None):
        self.train_step = train_step
        self.eval_step = eval_step
        self.schedule = schedule
        self.log_interval = log_interval
        self.logger = logger or logging.getLogger("openeat_torch")
        self.metrics_file = metrics_file
        self.group = None if mesh is None else mesh.data_group
        if mesh is not None and dist.get_rank() != 0:
            self.metrics_file = None

    def _emit(self, record: dict) -> None:
        if self.metrics_file:
            with open(self.metrics_file, "a") as f:
                f.write(json.dumps(record) + "\n")

    def train(self, state: TrainState, batches: Iterable[dict],
              generator: torch.Generator | None, epoch: int = 0,
              chunk_generator: torch.Generator | None = None) -> dict:
        """One epoch over device batches; returns the epoch summary.
        `generator` and `chunk_generator` go to the train step."""
        n_batches = 0
        run_loss = run_acc = run_ok = frames = 0.0
        t0 = time.time()
        for i, batch in enumerate(batches):
            with span("openeat.step"):
                metrics = self.train_step(state, batch, generator,
                                          chunk_generator)
                loss = metrics["loss"]
                ok = torch.isfinite(loss)
                run_loss = run_loss + torch.where(ok, loss, 0.0)
                run_acc = run_acc + torch.where(ok, metrics["acc"], 0.0)
                run_ok = run_ok + ok.float()
                frames = frames + batch["features_length"].sum()
                n_batches += 1
            if (i + 1) % self.log_interval == 0:
                lr = (self.schedule(state.n_applied) if self.schedule
                      else float("nan"))
                rec = {"kind": "train", "epoch": epoch, "batch": i + 1,
                       "step": state.step, "loss": float(loss),
                       "acc": float(metrics["acc"]), "lr": lr,
                       "grad_norm": float(metrics["grad_norm"]),
                       "skipped": float(metrics["skipped"]),
                       "time": time.time()}
                if "moe_aux" in metrics:
                    rec["moe_aux"] = float(metrics["moe_aux"])
                self.logger.info(
                    "epoch %d batch %d loss %.4f acc %.4f lr %.6g gnorm "
                    "%.2f", epoch, i + 1, rec["loss"], rec["acc"], lr,
                    rec["grad_norm"])
                self._emit(rec)
        n_seen = float(run_ok)
        dt = time.time() - t0
        frames = float(global_sum(torch.as_tensor(frames), self.group))
        summary = {
            "train_loss": float(run_loss) / max(n_seen, 1),
            "train_acc": float(run_acc) / max(n_seen, 1),
            "batches": n_batches,
            "epoch_time_s": dt,
            "frames_per_s": frames / max(dt, 1e-9),
            "audio_sec_per_s": frames * 0.01 / max(dt, 1e-9),
        }
        self._emit({"kind": "epoch", "epoch": epoch, **summary,
                    "time": time.time()})
        return summary

    def cv(self, batches: Iterable[dict], epoch: int = 0) -> dict:
        """No-grad loop; loss and accuracy weighted by batch size."""
        run_loss = run_acc = n_utts = 0.0
        for i, batch in enumerate(batches):
            metrics = self.eval_step(batch)
            bsz = global_count(batch["features_length"].numel(), self.group)
            loss = metrics["loss"]
            ok = torch.isfinite(loss)
            run_loss = run_loss + torch.where(ok, loss, 0.0) * bsz
            run_acc = run_acc + torch.where(ok, metrics["acc"], 0.0) * bsz
            n_utts = n_utts + ok.float() * bsz
            if (i + 1) % self.log_interval == 0:
                self.logger.info("cv epoch %d batch %d loss %.4f", epoch,
                                 i + 1, float(loss))
        n = max(float(n_utts), 1)
        return {"cv_loss": float(run_loss) / n, "cv_acc": float(run_acc) / n}
