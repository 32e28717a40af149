"""The quality drive's configs. Port of the config derivations in
benchmarks/run_recipe_tpu.sh: the profile table (`:20-58`), the synth
training config (`:91-113`) and the LM config (`:181-186`); of
benchmarks/run_streaming_hard.sh's streaming config (`:44-62`); and of
benchmarks/run_moe_hard.sh's mixture-of-experts config (`:42-54`).

The base configs are the repo's YAML, read with the port's reader
(openeat_torch/config.py:load_config); the derived ones are written as
JSON, which load_config reads back. No PyYAML.

    python -m openeat_torch.quality.confs profile PROFILE
    python -m openeat_torch.quality.confs train BASE PROFILE MAX_EPOCH OUT
    python -m openeat_torch.quality.confs lm BASE EPOCHS OUT
    python -m openeat_torch.quality.confs stream BASE MAX_EPOCH OUT
    python -m openeat_torch.quality.confs moe BASE MAX_EPOCH OUT

`profile` prints the profile's settings as shell assignments, which
openeat_torch/quality/run_recipe.sh evaluates.
"""

from __future__ import annotations

import argparse
import json
import shlex
from dataclasses import dataclass

from openeat_torch.config import load_config


@dataclass(frozen=True)
class Profile:
    """What a corpus profile changes in the drive."""
    corpus_flags: tuple   # extra flags of make_structured_corpus
    n_test: int           # test utterances those flags give
    ngram_order: int      # order of the KN ARPA (stage 5)
    lm_epochs: int        # transformer-LM epochs (stage 5)
    warmup_epoch: int     # WarmupLR epochs of the acoustic model


PROFILES = {
    "v1": Profile(corpus_flags=(), n_test=512, ngram_order=3, lm_epochs=8,
                  warmup_epoch=2),
    # 2048 test utterances: at ~8% CER the paired-bootstrap noise floor
    # is about 0.1 CER points
    "hard": Profile(corpus_flags=("--hard", "--n_test", "2048"),
                    n_test=2048, ngram_order=3, lm_epochs=8,
                    warmup_epoch=2),
    # the order-4 pair prior is learnable only from the 100k-sentence
    # lm_text split, so the LMs train on it (order-4 n-gram; 6 epochs of
    # it are about 55 epochs of train/text). Warmup 8: at warmup 2 the
    # flagship reaches its peak lr before CTC alignment settles on this
    # corpus and creeps at a train loss of about 29 for 20+ epochs
    "lmhard": Profile(corpus_flags=("--profile", "lmhard", "--n_test",
                                    "2048"),
                      n_test=2048, ngram_order=4, lm_epochs=6,
                      warmup_epoch=8),
}

TRAIN_LR = 0.0005
LOG_INTERVAL = 40
# the streamed drive's model: causal convolutions and static 16-frame
# chunks with unlimited left context in training. Its warmup is 8
# epochs: at the hard profile's 2 the causal flagship creeps at a train
# loss of about 29 for 35+ epochs
STREAM_MODEL = dict(causal=True, static_chunk_size=16, num_left_chunks=-1)
STREAM_WARMUP_EPOCH = 8
# the MoE drive's encoder feed-forward: GShard top-2-of-4 with static
# capacity and the Switch aux loss, the MoE keys of
# examples/aishell/conf/train_conformer_moe.yaml. Its warmup is 8
# epochs: at the hard profile's 2 the routed flagship never aligns
MOE_MODEL = dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=1.25,
                 moe_aux_weight=0.01)
MOE_WARMUP_EPOCH = 8


def synth_train_conf(base: str, profile: str, max_epoch: int) -> dict:
    """The acoustic model's config for the structured corpus, from the
    TPU conf at `base`: static 64-utterance batches (160 optimizer steps
    an epoch on 10,240 utterances), utterances of 10-400 frames,
    SpecAugment's time masks re-scaled for 1-2 s utterances (2 x 15
    frames), peak lr 5e-4 after the profile's warmup epochs."""
    cfg = load_config(base)
    cfg["dataset_conf"].update(batch_type="static", batch_size=64,
                               max_length=400, min_length=10)
    cfg["collate_conf"]["spec_aug_conf"].update(num_t_mask=2, max_t=15)
    cfg["max_epoch"] = max_epoch
    cfg["warmup_epoch"] = PROFILES[profile].warmup_epoch
    cfg["optim_conf"]["lr"] = TRAIN_LR
    cfg["log_interval"] = LOG_INTERVAL
    return cfg


def synth_lm_conf(base: str, epochs: int) -> dict:
    """The transformer LM's config: the conf at `base` with `epochs`."""
    cfg = load_config(base)
    cfg["max_epoch"] = epochs
    return cfg


def stream_train_conf(base: str, max_epoch: int) -> dict:
    """The streamed drive's config: the hard profile's synth config
    with STREAM_MODEL in its model_conf and STREAM_WARMUP_EPOCH. Global
    CMVN replaces per-utterance normalization through bin.train's
    --cmvn_file, not through the config."""
    cfg = synth_train_conf(base, "hard", max_epoch)
    cfg["model_conf"].update(STREAM_MODEL)
    cfg["warmup_epoch"] = STREAM_WARMUP_EPOCH
    return cfg


def moe_train_conf(base: str, max_epoch: int) -> dict:
    """The MoE drive's config: the hard profile's synth config with
    MOE_MODEL in its model_conf and MOE_WARMUP_EPOCH; per-utterance
    normalization stays."""
    cfg = synth_train_conf(base, "hard", max_epoch)
    cfg["model_conf"].update(MOE_MODEL)
    cfg["warmup_epoch"] = MOE_WARMUP_EPOCH
    return cfg


def shell_assignments(profile: str) -> str:
    """The profile's settings as `name=value` lines for the shell."""
    prof = PROFILES[profile]
    values = {"corpus_flags": " ".join(prof.corpus_flags),
              "n_test": prof.n_test, "ngram_order": prof.ngram_order,
              "lm_epochs": prof.lm_epochs}
    return "\n".join(f"{k}={shlex.quote(str(v))}" for k, v in values.items())


def _write(cfg: dict, out: str) -> None:
    with open(out, "w", encoding="utf-8") as f:
        json.dump(cfg, f, indent=1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("profile")
    sp.add_argument("profile", choices=sorted(PROFILES))
    st = sub.add_parser("train")
    st.add_argument("base")
    st.add_argument("profile", choices=sorted(PROFILES))
    st.add_argument("max_epoch", type=int)
    st.add_argument("out")
    sl = sub.add_parser("lm")
    sl.add_argument("base")
    sl.add_argument("epochs", type=int)
    sl.add_argument("out")
    for name in ("stream", "moe"):
        ss = sub.add_parser(name)
        ss.add_argument("base")
        ss.add_argument("max_epoch", type=int)
        ss.add_argument("out")
    args = p.parse_args(argv)
    if args.cmd == "profile":
        print(shell_assignments(args.profile))
    elif args.cmd == "train":
        _write(synth_train_conf(args.base, args.profile, args.max_epoch),
               args.out)
    elif args.cmd == "stream":
        _write(stream_train_conf(args.base, args.max_epoch), args.out)
    elif args.cmd == "moe":
        _write(moe_train_conf(args.base, args.max_epoch), args.out)
    else:
        _write(synth_lm_conf(args.base, args.epochs), args.out)


if __name__ == "__main__":
    main()
