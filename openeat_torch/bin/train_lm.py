"""Language-model training entry point (PyTorch). Port of
openeat_tpu/bin/train_lm.py, with its flags plus --device (default
cuda; cpu must be asked for).

    python -m openeat_torch.bin.train_lm --config lm.json \
        --train_data text --cv_data dev_text --dict dict.txt \
        --exp_dir exp_lm [--device cpu]

TextDataset + TextCollate (BERT-style masking when model_conf sets
autoregressive: false) + LanguageModel, trained with the ASR trainer's
step (parallel/train_step.py with the LM's loss_fn: Adam with WarmupLR,
grad clip, the non-finite skip, dropout from a seeded generator). Per
epoch: train over the batches in a seeded shuffled order, the cv loss
and accuracy weighted by batch size, then `epoch_N.pt` with its info
`epoch_N.json`; the resolved config goes to `train.json`, which
recognize's --lm_config reads. --checkpoint initializes the weights from
a .pt and starts at epoch 0, as the JAX trainer does.

--dp N --tp M (or mesh_conf) run under torchrun, one process per rank,
as openeat_torch/parallel/mesh.py describes: each batch is wrapped
around to a multiple of dp x accum_grad, as the JAX trainer's
shard_batch does, and each data rank takes its rows (of each
micro-batch); the TP rules reach the LM's embed, attention, FFN and
output layer by the ASR model's names. The first rank alone writes the
files. --bpe_model tokenizes the text with a BPE model, as the ASR
trainer does.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import time

import numpy as np
import torch

from openeat_torch.bin.train import dropout_seed, file_logger, writes_files
from openeat_torch.config import TrainConfig, load_config, mesh_layout
from openeat_torch.dataset.bpe import load_bpe
from openeat_torch.dataset.dataset import (PrefetchLoader, TextCollate,
                                           TextDataset)
from openeat_torch.dataset.text import load_dict
from openeat_torch.models.asr_model import init_parameters
from openeat_torch.models.language_model import build_language_model
from openeat_torch.parallel.mesh import (apply_mesh, close_mesh,
                                         full_state_dict, init_mesh)
from openeat_torch.parallel.train_step import (TrainState, build_eval_step,
                                               build_train_step)
from openeat_torch.pipeline import pad_rows
from openeat_torch.utils import checkpoint as ckpt_lib
from openeat_torch.utils.common import make_generator, resolve_device
from openeat_torch.utils.optim import build_optimizer


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="train a language model "
                                            "(PyTorch)")
    p.add_argument("--config", required=True, help=".json or .yaml")
    p.add_argument("--train_data", required=True,
                   help="text lines, '<utt> <text>' or bare text")
    p.add_argument("--cv_data", required=True)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--dict", dest="dict_path", required=True)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a CUDA "
                        "device raises")
    p.add_argument("--bpe_model", default=None)
    p.add_argument("--checkpoint", default=None,
                   help=".pt state_dict to initialize from")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--max_epoch", type=int, default=None)
    p.add_argument("--dp", type=int, default=None)
    p.add_argument("--tp", type=int, default=None)
    return p


def lm_loss(model, batch: dict) -> dict[str, torch.Tensor]:
    return model(batch["tokens"], batch["tokens_length"],
                 batch.get("masked_targets"))


def to_device(batch: dict, device: torch.device, accum: int = 1,
              mesh=None) -> dict:
    """Host batch -> int64 tensors on `device`, as the JAX trainer's
    shard_batch lays it out: the rows wrapped around up to a multiple
    of dp x accum, [accum, micro, ...] with accum > 1, and on a mesh
    this data rank's rows (of each micro-batch)."""
    batch = pad_rows(batch, (1 if mesh is None else mesh.dp) * accum)
    out = {k: torch.from_numpy(np.asarray(v, np.int64)).to(device)
           for k, v in batch.items()}
    if accum > 1:
        out = {k: v.reshape((accum, -1) + v.shape[1:])
               for k, v in out.items()}
    if mesh is not None:
        rows = mesh.rows(out["tokens"].shape[accum > 1])
        out = {k: v[:, rows] if accum > 1 else v[rows]
               for k, v in out.items()}
    return out


def main(argv=None):
    args = get_parser().parse_args(argv)
    cfg = load_config(args.config)
    device = resolve_device(args.device)
    mesh, device = init_mesh(*mesh_layout(cfg, args.dp, args.tp), device)
    log_file = None
    try:
        os.makedirs(args.exp_dir, exist_ok=True)
        logger, log_file = file_logger(args.exp_dir, mesh)
        return _train(args, cfg, device, logger, mesh)
    finally:
        if log_file is not None:
            logger.removeHandler(log_file)
            log_file.close()
        close_mesh(mesh)


def _train(args, cfg: dict, device: torch.device, logger: logging.Logger,
           mesh) -> TrainState:
    train_cfg = TrainConfig.from_dict(cfg)
    if args.max_epoch is not None:
        train_cfg.max_epoch = args.max_epoch
    seed = train_cfg.seed
    char_dict = load_dict(args.dict_path)
    model_conf = dict(cfg.get("model_conf", {}) or {})
    dataset_conf = dict(cfg.get("dataset_conf", {}) or {})
    ds_kwargs = dict(
        token_max_length=dataset_conf.get("token_max_length", 200),
        token_min_length=dataset_conf.get("token_min_length", 0),
        batch_size=dataset_conf.get("batch_size", 32),
        sort=dataset_conf.get("sort", True))
    bpe = load_bpe(args.bpe_model)
    train_ds = TextDataset(args.train_data, char_dict, bpe, **ds_kwargs)
    cv_ds = TextDataset(args.cv_data, char_dict, bpe, **ds_kwargs)
    collate = TextCollate(len(char_dict),
                          model_conf.get("autoregressive", True), seed=seed)
    logger.info("train batches %d cv batches %d", len(train_ds), len(cv_ds))

    model = build_language_model(model_conf, len(char_dict))
    init_parameters(model, make_generator(seed))
    if args.checkpoint:
        model.load_state_dict(ckpt_lib.load_checkpoint(args.checkpoint)[0])
    model.to(device)
    apply_mesh(model, mesh)
    writer = writes_files(mesh)
    if writer:
        with open(os.path.join(args.exp_dir, "train.json"), "w") as f:
            json.dump(dict(cfg, vocab_size=len(char_dict)), f, indent=1)

    steps_per_epoch = max(len(train_ds), 1)
    warmup = (train_cfg.warmup_steps if train_cfg.warmup_steps
              else int(train_cfg.warmup_epoch * steps_per_epoch))
    optimizer, schedule = build_optimizer(model, train_cfg.lr, warmup,
                                          train_cfg.optim)
    state = TrainState(model, optimizer)
    accum = train_cfg.accum_grad
    train_step = build_train_step(schedule, accum, train_cfg.grad_clip,
                                  loss_fn=lm_loss, mesh=mesh)
    eval_step = build_eval_step(model, loss_fn=lm_loss, mesh=mesh)
    metrics_path = os.path.join(args.exp_dir, "metrics.jsonl")
    data_rank = None if mesh is None or mesh.dp == 1 else mesh.data_rank

    for epoch in range(train_cfg.max_epoch):
        loader = PrefetchLoader(train_ds, collate, args.num_workers,
                                shuffle_batches=True, seed=seed + epoch)
        gen = make_generator(dropout_seed(seed, epoch, data_rank), device)
        t0 = time.time()
        for i, batch in enumerate(loader):
            m = train_step(state, to_device(batch, device, accum, mesh), gen)
            if writer and (i + 1) % train_cfg.log_interval == 0:
                rec = {"kind": "train", "epoch": epoch, "batch": i + 1,
                       "step": state.step, "loss": float(m["loss"]),
                       "acc": float(m["acc"]),
                       "grad_norm": float(m["grad_norm"])}
                logger.info("epoch %d step %d loss %.4f acc %.4f", epoch,
                            state.step, rec["loss"], rec["acc"])
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        cv_loss = cv_acc = 0.0
        n = 0
        for batch in PrefetchLoader(cv_ds, collate, args.num_workers):
            b = len(batch["tokens"])
            m = eval_step(to_device(batch, device, mesh=mesh))
            if math.isfinite(float(m["loss"])):
                cv_loss += float(m["loss"]) * b
                cv_acc += float(m["acc"]) * b
                n += b
        info = {"epoch": epoch + 1, "step": state.step,
                "n_applied": state.n_applied,
                "lr": schedule(state.n_applied),
                "cv_loss": cv_loss / max(n, 1), "cv_acc": cv_acc / max(n, 1),
                "epoch_time_s": time.time() - t0}
        logger.info("epoch %d done: %s", epoch, info)
        weights = full_state_dict(model, mesh)
        if writer:
            with open(metrics_path, "a") as f:
                f.write(json.dumps({"kind": "epoch", **info}) + "\n")
            ckpt_lib.save_checkpoint(args.exp_dir, f"epoch_{epoch + 1}",
                                     weights, info)
    logger.info("training finished")
    return state


if __name__ == "__main__":
    main()
