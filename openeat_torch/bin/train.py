"""ASR training entry point (PyTorch, one device).

Port of openeat_tpu/bin/train.py: the same flags, plus --device (default
cuda; cpu must be asked for). Per epoch: train (dynamic batches in a
seeded shuffled order, on-device frontend with SpecAugment, dropout,
Adam with WarmupLR, grad clip and the non-finite skip), then cv, then
the checkpoint `epoch_N.pt` with its info `epoch_N.json`, and the
rolling `optimizer.pt` that makes `--checkpoint exp/epoch_N.pt` resume
exactly. The resolved config is written as `train.json`, which
openeat_torch.bin.recognize reads (JSON: the port does not depend on
PyYAML; the JAX trainer writes `.yaml`).

Refused with NotImplementedError, each naming the slice that brings it:
--bpe_model, --data_type feat/kaldi, --dp/--tp other than 1,
--multihost, --only_adapter, --cmvn_file (and checkpoints carrying
global CMVN statistics), --profile_dir, speed perturbation and wav
dither in the config.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

from openeat_torch.config import TrainConfig, load_config
from openeat_torch.dataset.dataset import (AudioCollate, AudioDataset,
                                           PrefetchLoader)
from openeat_torch.dataset.text import load_dict
from openeat_torch.models.asr_model import build_asr_model, init_parameters
from openeat_torch.ops.frontend import FrontendConfig
from openeat_torch.parallel.train_step import (TrainState, build_eval_step,
                                               build_train_step)
from openeat_torch.pipeline import DeviceFeeder
from openeat_torch.utils import checkpoint as ckpt_lib
from openeat_torch.utils.common import (LOG_FORMAT, init_logger,
                                        make_generator, resolve_device)
from openeat_torch.utils.executor import Executor
from openeat_torch.utils.optim import build_optimizer


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="train an ASR model (PyTorch)")
    p.add_argument("--config", required=True, help=".json or .yaml")
    p.add_argument("--train_data", required=True)
    p.add_argument("--cv_data", required=True)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--dict", dest="dict_path", required=True)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a CUDA "
                        "device raises")
    p.add_argument("--bpe_model", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="epoch_N.pt to resume (or init) from")
    p.add_argument("--init_mods", default="encoder.,ctc.,decoder.",
                   help="comma-separated module prefixes for partial init")
    p.add_argument("--cmvn_file", default=None)
    p.add_argument("--is_json_cmvn", type=lambda s: s.lower() != "false",
                   default=True)
    p.add_argument("--only_adapter", action="store_true")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--dp", type=int, default=None)
    p.add_argument("--tp", type=int, default=None)
    p.add_argument("--max_epoch", type=int, default=None)
    p.add_argument("--data_type", default="wav",
                   choices=["wav", "feat", "kaldi"])
    p.add_argument("--profile_dir", default=None)
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--save_optimizer", type=lambda s: s.lower() != "false",
                   default=True,
                   help="keep the rolling optimizer.pt so a --checkpoint "
                        "resume is exact")
    return p


def refuse_unported(args, cfg: dict) -> None:
    """Raise NotImplementedError for what this port does not do yet."""
    collate_conf = cfg.get("collate_conf", {}) or {}
    fe_conf = collate_conf.get("feature_extraction_conf", {}) or {}
    dataset_conf = cfg.get("dataset_conf", {}) or {}
    later = {
        "--bpe_model": (args.bpe_model is not None,
                        "a later slice (BPE tokenizer)"),
        "--data_type feat/kaldi": (args.data_type != "wav",
                                   "a later slice (kaldi ark input)"),
        "--dp/--tp": (args.dp not in (None, 1) or args.tp not in (None, 1),
                      "the parallel-layout slice"),
        "--multihost": (args.multihost, "the parallel-layout slice"),
        "--only_adapter": (args.only_adapter, "a later slice (adapters)"),
        "--cmvn_file": (args.cmvn_file is not None,
                        "a later slice (global CMVN)"),
        "--profile_dir": (args.profile_dir is not None,
                          "a later slice (profiler traces)"),
        "speed perturbation": (
            bool(dataset_conf.get("speed_perturb"))
            or bool(fe_conf.get("speed_perturb_rate")),
            "a later slice (speed perturbation)"),
        "wav_dither": (bool(fe_conf.get("wav_dither")),
                       "a later slice (fbank dither path)"),
    }
    for what, (asked, where) in later.items():
        if asked:
            raise NotImplementedError(
                f"{what} is not ported to openeat_torch yet; it comes "
                f"with {where}")


def _dropout_seed(seed: int, epoch: int) -> int:
    """Seed of an epoch's dropout generator: a stream apart from the
    frontend's and the loader's (seed + epoch), and the same on a
    resumed run as on an uninterrupted one."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])


def main(argv=None) -> TrainState:
    args = get_parser().parse_args(argv)
    cfg = load_config(args.config)
    refuse_unported(args, cfg)
    device = resolve_device(args.device)
    os.makedirs(args.exp_dir, exist_ok=True)
    logger = init_logger()
    log_file = logging.FileHandler(os.path.join(args.exp_dir, "train.log"))
    log_file.setFormatter(logging.Formatter(LOG_FORMAT))
    logger.addHandler(log_file)
    try:
        return _train(args, cfg, device, logger)
    finally:
        logger.removeHandler(log_file)
        log_file.close()


def _train(args, cfg: dict, device: torch.device,
           logger: logging.Logger) -> TrainState:
    train_cfg = TrainConfig.from_dict(cfg)
    if args.max_epoch is not None:
        train_cfg.max_epoch = args.max_epoch
    seed = train_cfg.seed

    char_dict = load_dict(args.dict_path)
    vocab_size = len(char_dict)
    dataset_conf = dict(cfg.get("dataset_conf", {}) or {})
    collate_conf = dict(cfg.get("collate_conf", {}) or {})
    fe_conf = collate_conf.get("feature_extraction_conf", {}) or {}
    ds_kwargs = dict(
        max_length=dataset_conf.get("max_length", 10240),
        min_length=dataset_conf.get("min_length", 0),
        token_max_length=dataset_conf.get("token_max_length", 200),
        token_min_length=dataset_conf.get("token_min_length", 0),
        batch_type=dataset_conf.get("batch_type", "dynamic"),
        batch_size=dataset_conf.get("batch_size", 12),
        max_frames_in_batch=dataset_conf.get("max_frames_in_batch", 10000),
        sort=dataset_conf.get("sort", True), seed=seed)
    train_ds = AudioDataset(args.train_data, char_dict, **ds_kwargs)
    cv_ds = AudioDataset(args.cv_data, char_dict, **ds_kwargs)
    logger.info("train batches %d cv batches %d vocab %d", len(train_ds),
                len(cv_ds), vocab_size)
    collate = AudioCollate(resample_rate=fe_conf.get("resample_rate", 16000))
    frontend = FrontendConfig.from_collate_conf(collate_conf)
    input_size = fe_conf.get("mel_bins", 80)

    ckpt_src, ckpt_info = (ckpt_lib.load_checkpoint(args.checkpoint)
                           if args.checkpoint else (None, {}))
    if ckpt_src is not None and "encoder.global_cmvn.mean" in ckpt_src:
        raise NotImplementedError(
            f"{args.checkpoint} carries global CMVN statistics, which "
            "openeat_torch's trainer does not take yet; it comes with a "
            "later slice (global CMVN)")

    model_conf = dict(cfg.get("model_conf", {}) or {})
    model = build_asr_model(model_conf, input_size, vocab_size)
    init_parameters(model, make_generator(seed))
    model.to(device)

    resolved = dict(cfg, input_size=input_size, vocab_size=vocab_size,
                    use_global_cmvn=False)
    with open(os.path.join(args.exp_dir, "train.json"), "w") as f:
        json.dump(resolved, f, indent=1)

    steps_per_epoch = max(len(train_ds), 1)
    warmup_steps = (train_cfg.warmup_steps if train_cfg.warmup_steps
                    else int(train_cfg.warmup_epoch * steps_per_epoch))
    optimizer, schedule = build_optimizer(model, train_cfg.lr, warmup_steps,
                                          train_cfg.optim)
    state = TrainState(model, optimizer)

    start_epoch = 0
    if ckpt_src is not None:
        mods = args.init_mods.split(",")
        new, copied = ckpt_lib.load_trained_modules(model.state_dict(),
                                                    ckpt_src, mods)
        model.load_state_dict(new)
        logger.info("initialized %d tensors from %s", len(copied),
                    args.checkpoint)
        if ckpt_info.get("epoch") is not None:
            start_epoch = int(ckpt_info["epoch"])
            state.step = int(ckpt_info.get("step", 0))
            opt_path = os.path.join(
                os.path.dirname(os.path.abspath(args.checkpoint)),
                "optimizer.pt")
            if os.path.exists(opt_path):
                saved = ckpt_lib.load_optimizer(opt_path)
                if int(saved.get("epoch", -1)) == start_epoch:
                    optimizer.load_state_dict(saved["optimizer"])
                    state.n_applied = int(saved["n_applied"])
                    logger.info("restored optimizer state (epoch %d)",
                                start_epoch)

    executor = Executor(
        build_train_step(schedule, train_cfg.accum_grad, train_cfg.grad_clip),
        build_eval_step(model), schedule, train_cfg.log_interval, logger,
        metrics_file=os.path.join(args.exp_dir, "metrics.jsonl"))
    for epoch in range(start_epoch, train_cfg.max_epoch):
        train_feed = DeviceFeeder(
            PrefetchLoader(train_ds, collate, args.num_workers,
                           shuffle_batches=True, seed=seed + epoch),
            frontend, device, train=True, seed=seed + epoch,
            accum_grad=train_cfg.accum_grad)
        dropout_gen = make_generator(_dropout_seed(seed, epoch), device)
        summary = executor.train(state, (b for _, b in train_feed),
                                 dropout_gen, epoch)
        cv_feed = DeviceFeeder(PrefetchLoader(cv_ds, collate,
                                              args.num_workers),
                               frontend.without_augmentation(), device)
        cv_metrics = executor.cv((b for _, b in cv_feed), epoch)
        info = {"epoch": epoch + 1, "step": state.step,
                "n_applied": state.n_applied,
                "lr": schedule(state.n_applied), **cv_metrics, **summary}
        logger.info("epoch %d done: %s", epoch, info)
        ckpt_lib.save_checkpoint(args.exp_dir, f"epoch_{epoch + 1}",
                                 model.state_dict(), info)
        if args.save_optimizer:
            ckpt_lib.save_optimizer(args.exp_dir, optimizer, state.n_applied,
                                    epoch + 1, state.step)
    logger.info("training finished")
    return state


if __name__ == "__main__":
    main()
