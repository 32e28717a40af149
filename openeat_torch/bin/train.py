"""ASR training entry point (PyTorch).

Port of openeat_tpu/bin/train.py: the same flags, plus --device (default
cuda; cpu must be asked for). Per epoch: train (dynamic batches in a
seeded shuffled order, on-device frontend with SpecAugment, dropout,
Adam with WarmupLR, grad clip and the non-finite skip), then cv, then
the checkpoint `epoch_N.pt` with its info `epoch_N.json`, and the
rolling `optimizer.pt` that makes `--checkpoint exp/epoch_N.pt` resume
exactly. The resolved config is written as `train.json`, which
openeat_torch.bin.recognize and bin.stream_recognize read (JSON: the
port does not depend on PyYAML; the JAX trainer writes `.yaml`). A
streaming config trains as the JAX trainer trains it: static chunk
masks throughout, or with use_dynamic_chunk a chunk size drawn per
batch from the epoch's dropout generator in training, the cv pass
full-context.

Data, tensor and expert parallelism: run one process per card under
torchrun with --dp N --tp M (or mesh_conf data/model; N * M ranks, --dp
-1 the rest), as openeat_torch/parallel/mesh.py describes. Every rank
reads the same seeded batch order, pads each batch to a multiple of its
data ranks and takes its rows; with --multihost the loader splits the
batches by node instead, as the JAX trainer splits them by process.
Each data rank's dropout generator folds its data rank into the seed;
the dynamic chunk draw comes from one more generator, seeded alike on
every data rank (dropout_seed without the rank), so that the data group
trains one chunk size a step, as the JAX trainer draws one a global
batch. With model_conf.sequence_sharding and --tp M the encoder's block
stack shards time over the model group (openeat_torch/modules/
encoder.py); pipeline parallelism has no flag, as in JAX
(openeat_torch/parallel/pipeline.py is a library).
The first rank alone writes train.json, the checkpoints (gathered to
full tensors), optimizer.pt, metrics.jsonl and train.log; the logged
metrics are the global batch's.

Fine-tuning, as the JAX trainer does it:
- global CMVN: --cmvn_file (JSON, or kaldi text with --is_json_cmvn
  false), or a --checkpoint that carries encoder.global_cmvn.* (a
  converted WeNet release: openeat_torch.bin.convert_wenet), builds the
  model with GlobalCMVN. The file's statistics are loaded before the
  checkpoint, whose own win. Global CMVN and per-utterance
  normalization exclude each other: collate_conf.normalization: true
  raises ValueError, an unset one becomes false. train.json records
  use_global_cmvn and normalization, so that recognize builds the same
  model and frontend;
- --only_adapter trains only the adapters (model_conf
  encoder_use_adapter / decoder_use_adapter); every parameter still
  gets its gradient, counted in the clip norm (utils/optim.py), and a
  --checkpoint is an init only: no epoch, step or optimizer state is
  restored;
- speed perturbation: dataset_conf.speed_perturb (one manifest entry a
  speed of dataset_conf.speeds) and feature_extraction_conf
  speed_perturb_rate (the collate's online draw from speeds);
  feature_extraction_conf.wav_dither adds noise to the framed samples;
- --profile_dir traces 3 train steps on the first batch, after one
  untraced step, before epoch 0 (utils/profiling.py: a Chrome trace of
  CPU and CUDA activity). Unlike the JAX trainer, whose traced steps
  train the model, the model, the optimizer and the step counts are
  restored afterwards and the steps draw from generators of their own,
  so a run with --profile_dir writes the checkpoints a run without it
  writes.

Inputs, as the JAX trainer takes them: --bpe_model tokenizes the
transcripts with a BPE model (openeat_torch.bin.train_bpe's JSON, or a
sentencepiece .model where sentencepiece is installed); a wav.scp entry
may be WAV or FLAC; --data_type feat (or kaldi) reads precomputed kaldi
ark features (`feat_shape: frames,dim` entries), the model's input_size
is their dim, and the device runs only the frontend's feature-level
tail (normalization, SpecAugment) on them.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from openeat_torch.config import TrainConfig, load_config, mesh_layout
from openeat_torch.dataset.bpe import load_bpe
from openeat_torch.dataset.dataset import (AudioCollate, AudioDataset,
                                           PrefetchLoader)
from openeat_torch.dataset.text import load_dict
from openeat_torch.models.asr_model import build_asr_model, init_parameters
from openeat_torch.ops.frontend import FrontendConfig
from openeat_torch.parallel.mesh import (apply_mesh, close_mesh,
                                         full_optimizer_state,
                                         full_state_dict, init_mesh,
                                         shard_optimizer_state)
from openeat_torch.parallel.train_step import (TrainState, build_eval_step,
                                               build_train_step)
from openeat_torch.pipeline import DeviceFeeder
from openeat_torch.utils import checkpoint as ckpt_lib
from openeat_torch.utils.common import (LOG_FORMAT, init_logger,
                                        make_generator, resolve_device)
from openeat_torch.utils.cmvn import load_cmvn
from openeat_torch.utils.executor import Executor
from openeat_torch.utils.optim import build_optimizer
from openeat_torch.utils.profiling import trace


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


def dropout_seed(seed: int, epoch: int, data_rank: int | None = None
                 ) -> int:
    """Seed of an epoch's dropout generator: a stream apart from the
    frontend's and the loader's (seed + epoch), and the same on a
    resumed run as on an uninterrupted one. Under data parallelism each
    data rank folds its rank in, so the ranks draw different masks for
    their different rows."""
    entropy = [seed, epoch] + ([] if data_rank is None else [data_rank])
    return int(np.random.SeedSequence(entropy).generate_state(1)[0])


def frontend_seed(seed: int, epoch: int, mesh) -> int:
    """Seed of an epoch's SpecAugment generator: seed + epoch, the JAX
    feeder's; under --multihost each node draws for its own batches
    from its own stream."""
    if mesh is None or mesh.nodes == 1:
        return seed + epoch
    return int(np.random.SeedSequence(seed + epoch, spawn_key=(mesh.node,))
               .generate_state(1)[0])


def profile_steps(state: TrainState, train_step, batch: dict,
                  generator: torch.Generator, profile_dir: str,
                  device: torch.device) -> None:
    """One train step on `batch`, then 3 more under utils/profiling.trace
    (the JAX trainer's count); afterwards the model, the optimizer and
    the state's counts are what they were before, and the run's own
    generators were not drawn from."""
    saved = (copy.deepcopy(state.model.state_dict()),
             copy.deepcopy(state.optimizer.state_dict()), state.step,
             state.n_applied)
    train_step(state, batch, generator)
    with trace(profile_dir, device):
        for _ in range(3):
            train_step(state, batch, generator)
    state.model.load_state_dict(saved[0])
    state.optimizer.load_state_dict(saved[1])
    state.step, state.n_applied = saved[2], saved[3]
    state.model.zero_grad(set_to_none=True)


def writes_files(mesh) -> bool:
    """Whether this rank writes the run's files (the first rank)."""
    return mesh is None or dist.get_rank() == 0


def file_logger(exp_dir: str, mesh):
    """(logger, handler) with train.log attached on the writing rank."""
    logger = init_logger()
    if not writes_files(mesh):
        return logger, None
    log_file = logging.FileHandler(os.path.join(exp_dir, "train.log"))
    log_file.setFormatter(logging.Formatter(LOG_FORMAT))
    logger.addHandler(log_file)
    return logger, log_file


def main(argv=None) -> TrainState:
    args = get_parser().parse_args(argv)
    cfg = load_config(args.config)
    device = resolve_device(args.device)
    mesh, device = init_mesh(*mesh_layout(cfg, args.dp, args.tp), device,
                             args.multihost)
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
    vocab_size = len(char_dict)
    bpe = load_bpe(args.bpe_model)
    data_type = "wav" if args.data_type == "wav" else "feat"
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
        sort=dataset_conf.get("sort", True), seed=seed, data_type=data_type)
    speeds = (0.9, 1.1, 0.1)
    train_ds = AudioDataset(
        args.train_data, char_dict, bpe,
        speed_perturb=dataset_conf.get("speed_perturb", False),
        speeds=dataset_conf.get("speeds", speeds), **ds_kwargs)
    cv_ds = AudioDataset(args.cv_data, char_dict, bpe, **ds_kwargs)
    logger.info("train batches %d cv batches %d vocab %d", len(train_ds),
                len(cv_ds), vocab_size)
    rate = fe_conf.get("resample_rate", 16000)
    collate = AudioCollate(
        resample_rate=rate,
        speed_perturb_rate=fe_conf.get("speed_perturb_rate", 0.0),
        speeds=fe_conf.get("speeds", speeds), seed=seed)
    cv_collate = AudioCollate(resample_rate=rate)
    frontend = FrontendConfig.from_collate_conf(collate_conf)
    input_size = (fe_conf.get("mel_bins", 80) if data_type == "wav"
                  else train_ds.input_size)

    # the checkpoint is read before the model is built: its global CMVN
    # statistics (a converted WeNet release, a --cmvn_file run) decide
    # whether the model has GlobalCMVN, and then the features are raw
    # fbank, not per-utterance normalized
    ckpt_src, ckpt_info = (ckpt_lib.load_checkpoint(args.checkpoint)
                           if args.checkpoint else (None, {}))
    use_global_cmvn = args.cmvn_file is not None or (
        ckpt_src is not None and "encoder.global_cmvn.mean" in ckpt_src)
    if use_global_cmvn and frontend.normalization:
        if collate_conf.get("normalization") is True:
            raise ValueError(
                "collate_conf.normalization: true is incompatible with "
                "global CMVN (--cmvn_file or a checkpoint carrying "
                "global_cmvn statistics, which are over raw fbank); "
                "remove one of the two")
        frontend = dataclasses.replace(frontend, normalization=False)
        logger.info("global CMVN: per-utterance normalization disabled")
    cfg["collate_conf"] = dict(collate_conf,
                               normalization=frontend.normalization)

    model_conf = dict(cfg.get("model_conf", {}) or {})
    model = build_asr_model(model_conf, input_size, vocab_size,
                            use_global_cmvn=use_global_cmvn)
    init_parameters(model, make_generator(seed))
    if args.cmvn_file:
        mean, istd = load_cmvn(args.cmvn_file, args.is_json_cmvn)
        with torch.no_grad():
            model.encoder.global_cmvn.mean.copy_(torch.from_numpy(mean))
            model.encoder.global_cmvn.istd.copy_(torch.from_numpy(istd))
    if ckpt_src is not None:
        mods = args.init_mods.split(",")
        new, copied = ckpt_lib.load_trained_modules(model.state_dict(),
                                                    ckpt_src, mods)
        model.load_state_dict(new)
        logger.info("initialized %d tensors from %s", len(copied),
                    args.checkpoint)
    model.to(device)
    apply_mesh(model, mesh)
    if mesh is not None:
        logger.info("mesh data %d x model %d (%d nodes), rank %d on %s",
                    mesh.dp, mesh.tp, mesh.nodes, dist.get_rank(), device)
    writer = writes_files(mesh)

    resolved = dict(cfg, input_size=input_size, vocab_size=vocab_size,
                    use_global_cmvn=use_global_cmvn)
    if writer:
        with open(os.path.join(args.exp_dir, "train.json"), "w") as f:
            json.dump(resolved, f, indent=1)

    steps_per_epoch = max(len(train_ds), 1)
    warmup_steps = (train_cfg.warmup_steps if train_cfg.warmup_steps
                    else int(train_cfg.warmup_epoch * steps_per_epoch))
    optimizer, schedule = build_optimizer(model, train_cfg.lr, warmup_steps,
                                          train_cfg.optim,
                                          only_adapter=args.only_adapter)
    state = TrainState(model, optimizer)

    start_epoch = 0
    if ckpt_src is not None and ckpt_info.get("epoch") is not None \
            and not args.only_adapter:
        start_epoch = int(ckpt_info["epoch"])
        state.step = int(ckpt_info.get("step", 0))
        opt_path = os.path.join(
            os.path.dirname(os.path.abspath(args.checkpoint)),
            "optimizer.pt")
        if os.path.exists(opt_path):
            saved = ckpt_lib.load_optimizer(opt_path)
            if int(saved.get("epoch", -1)) == start_epoch:
                optimizer.load_state_dict(shard_optimizer_state(
                    saved["optimizer"], optimizer, mesh))
                state.n_applied = int(saved["n_applied"])
                logger.info("restored optimizer state (epoch %d)",
                            start_epoch)

    train_step = build_train_step(schedule, train_cfg.accum_grad,
                                  train_cfg.grad_clip, mesh=mesh)
    executor = Executor(
        train_step, build_eval_step(model, mesh=mesh), schedule,
        train_cfg.log_interval, logger,
        metrics_file=os.path.join(args.exp_dir, "metrics.jsonl"), mesh=mesh)
    shard = ({} if mesh is None or mesh.nodes == 1 else
             {"shard_id": mesh.node, "num_shards": mesh.nodes})
    feed = {} if mesh is None else {"mesh": mesh,
                                    "pad_batch_multiple": mesh.local_dp}
    data_rank = None if mesh is None or mesh.dp == 1 else mesh.data_rank
    if args.profile_dir:
        warm = DeviceFeeder(
            PrefetchLoader(train_ds, copy.deepcopy(collate), 1, **shard),
            frontend, device, train=True, seed=seed,
            accum_grad=train_cfg.accum_grad, **feed)
        profile_steps(state, train_step, next(iter(warm))[1],
                      make_generator(seed, device), args.profile_dir,
                      device)
        logger.info("profiler trace written to %s", args.profile_dir)
    for epoch in range(start_epoch, train_cfg.max_epoch):
        train_feed = DeviceFeeder(
            PrefetchLoader(train_ds, collate, args.num_workers,
                           shuffle_batches=True, seed=seed + epoch, **shard),
            frontend, device, train=True,
            seed=frontend_seed(seed, epoch, mesh),
            accum_grad=train_cfg.accum_grad, **feed)
        dropout_gen = make_generator(dropout_seed(seed, epoch, data_rank),
                                     device)
        chunk_gen = (None if data_rank is None else
                     make_generator(dropout_seed(seed, epoch), device))
        summary = executor.train(state, (b for _, b in train_feed),
                                 dropout_gen, epoch, chunk_gen)
        cv_feed = DeviceFeeder(PrefetchLoader(cv_ds, cv_collate,
                                              args.num_workers, **shard),
                               frontend.without_augmentation(), device,
                               **feed)
        cv_metrics = executor.cv((b for _, b in cv_feed), epoch)
        info = {"epoch": epoch + 1, "step": state.step,
                "n_applied": state.n_applied,
                "lr": schedule(state.n_applied), **cv_metrics, **summary}
        logger.info("epoch %d done: %s", epoch, info)
        weights = full_state_dict(model, mesh)
        opt_state = (full_optimizer_state(optimizer, mesh)
                     if args.save_optimizer else None)
        if writer:
            ckpt_lib.save_checkpoint(args.exp_dir, f"epoch_{epoch + 1}",
                                     weights, info)
            if opt_state is not None:
                ckpt_lib.save_optimizer(args.exp_dir, opt_state,
                                        state.n_applied, epoch + 1,
                                        state.step)
    logger.info("training finished")
    return state


if __name__ == "__main__":
    main()
