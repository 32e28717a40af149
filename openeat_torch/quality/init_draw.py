"""The port's own initial weights as an epoch-0 checkpoint.

Builds the model of a train config for the vocabulary of a dictionary,
draws `init_parameters(model, make_generator(seed))` on the CPU, as
`openeat_torch.bin.train` does before it moves the model to its device,
and writes the result as OUT/epoch_0.pt with the info
{"epoch": 0, "step": 0}. `bin.train --checkpoint OUT/epoch_0.pt` (or
run_recipe.sh's stage 2, which resumes from the newest epoch_N.pt)
then starts at epoch 0 and step 0 from these weights with a fresh
optimizer, while its dropout, SpecAugment and batch-order streams
still follow the config's own seed. So a drive can change its initial
draw and nothing else:

    python -m openeat_torch.quality.init_draw WORK/conf_synth.json \
        WORK/data/dict.txt 778 WORK/exp

prints one line: the path, the tensor count, the parameter count and
the sha256 of the state dict (`state_sha256`).
"""

from __future__ import annotations

import argparse
import hashlib

import torch

from openeat_torch.config import load_config
from openeat_torch.dataset.text import load_dict
from openeat_torch.models.asr_model import build_asr_model, init_parameters
from openeat_torch.utils import checkpoint as ckpt_lib
from openeat_torch.utils.common import make_generator


def draw(cfg: dict, vocab_size: int, seed: int) -> dict[str, torch.Tensor]:
    """The state dict of `bin.train`'s initial model for the config
    `cfg` at `seed`: the wav frontend's mel_bins as the input size, no
    global CMVN."""
    fe_conf = (cfg.get("collate_conf", {}) or {}).get(
        "feature_extraction_conf", {}) or {}
    model = build_asr_model(dict(cfg.get("model_conf", {}) or {}),
                            fe_conf.get("mel_bins", 80), vocab_size)
    init_parameters(model, make_generator(seed))
    return model.state_dict()


def state_sha256(state: dict[str, torch.Tensor]) -> str:
    """sha256 over the tensors in name order: each name, dtype and
    shape, then the tensor's bytes."""
    h = hashlib.sha256()
    for name in sorted(state):
        t = state[name].detach().cpu().contiguous()
        h.update(f"{name} {t.dtype} {tuple(t.shape)}\n".encode())
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel()
                 else b"")
    return h.hexdigest()


def write_epoch0(conf: str, dict_path: str, seed: int, out_dir: str
                 ) -> tuple[str, dict[str, torch.Tensor]]:
    """Write the draw as OUT/epoch_0.pt + epoch_0.json; returns the .pt
    path and the state dict."""
    state = draw(load_config(conf), len(load_dict(dict_path)), seed)
    path = ckpt_lib.save_checkpoint(out_dir, "epoch_0", state,
                                    {"epoch": 0, "step": 0})
    return path, state


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("conf", help="train config (.json or .yaml)")
    p.add_argument("dict", help="the drive's data/dict.txt")
    p.add_argument("seed", type=int)
    p.add_argument("out_dir")
    args = p.parse_args(argv)
    path, state = write_epoch0(args.conf, args.dict, args.seed,
                               args.out_dir)
    digest = state_sha256(state)
    n_params = sum(v.numel() for v in state.values())
    print(f"{path}: seed {args.seed}, {len(state)} tensors, {n_params} "
          f"parameters, sha256 {digest}", flush=True)
    return digest


if __name__ == "__main__":
    main()
