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
the sha256 of the state dict (`state_sha256`). `--per_tensor FILE`
also writes {name: sha256 of that tensor} as JSON, one entry a line, so
that two hosts' draws can be compared tensor by tensor; `--against
FILE` (another host's such file) then prints, for each group of
in-place calls that drew a tensor (`uniform_ erfinv_ mul_ add_ clamp_`
for a truncated normal, `normal_`, `uniform_`, `fill_`, `zero_`), how
many of its tensors differ. The truncated-normal group is the port's
own sequence (`_trunc_normal_` in openeat_torch/models/asr_model.py),
no longer torch's sampler, so the draw at a seed is the same under
torch 2.11 and 2.13 on an AVX2 or AVX512 CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json

import torch

from openeat_torch.config import load_config
from openeat_torch.dataset.text import load_dict
from openeat_torch.models.asr_model import build_asr_model, init_parameters
from openeat_torch.utils import checkpoint as ckpt_lib
from openeat_torch.utils.common import make_generator


class _InPlaceCalls(torch.overrides.TorchFunctionMode):
    """Records, for each tensor of a state dict, the in-place torch
    calls (`uniform_`, `erfinv_`, `normal_`, `fill_`, ...) made on it."""

    def __init__(self, state: dict[str, torch.Tensor]):
        super().__init__()
        self.names = {t.data_ptr(): k for k, t in state.items()
                      if t.numel()}
        self.calls: dict[str, list[str]] = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        if (name.endswith("_") and not name.startswith("_") and args
                and isinstance(args[0], torch.Tensor)):
            key = self.names.get(args[0].data_ptr())
            if key is not None:
                self.calls.setdefault(key, []).append(name)
        return out


def draw(cfg: dict, vocab_size: int, seed: int,
         calls: dict[str, str] | None = None) -> dict[str, torch.Tensor]:
    """The state dict of `bin.train`'s initial model for the config
    `cfg` at `seed`: the wav frontend's mel_bins as the input size, no
    global CMVN. A dict given as `calls` is filled with {name: the
    in-place calls that drew it, space-separated} ("" for a tensor left
    as built)."""
    fe_conf = (cfg.get("collate_conf", {}) or {}).get(
        "feature_extraction_conf", {}) or {}
    model = build_asr_model(dict(cfg.get("model_conf", {}) or {}),
                            fe_conf.get("mel_bins", 80), vocab_size)
    mode = _InPlaceCalls(model.state_dict())
    with mode:
        init_parameters(model, make_generator(seed))
    state = model.state_dict()
    if calls is not None:
        calls.update({k: " ".join(mode.calls.get(k, [])) for k in state})
    return state


def _hash_tensor(h, name: str, t: torch.Tensor):
    t = t.detach().cpu().contiguous()
    h.update(f"{name} {t.dtype} {tuple(t.shape)}\n".encode())
    h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")


def state_sha256(state: dict[str, torch.Tensor]) -> str:
    """sha256 over the tensors in name order: each name, dtype and
    shape, then the tensor's bytes."""
    h = hashlib.sha256()
    for name in sorted(state):
        _hash_tensor(h, name, state[name])
    return h.hexdigest()


def tensor_sha256(state: dict[str, torch.Tensor]) -> dict[str, str]:
    """{name: sha256 of that name, dtype, shape and bytes}, in name
    order."""
    out = {}
    for name in sorted(state):
        h = hashlib.sha256()
        _hash_tensor(h, name, state[name])
        out[name] = h.hexdigest()
    return out


def write_per_tensor(state: dict[str, torch.Tensor], path: str) -> None:
    """tensor_sha256 as a JSON object, one entry a line."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(tensor_sha256(state), f, indent=2)
        f.write("\n")


def differing(calls: dict[str, str], ours: dict[str, str],
              theirs: dict[str, str]) -> dict[str, tuple[int, list[str]]]:
    """{in-place calls: (the tensors they drew, the names of those whose
    sha256 differs between the two per-tensor files)}."""
    if set(ours) != set(theirs):
        raise ValueError("the two draws hold different tensors")
    out: dict[str, tuple[int, list[str]]] = {}
    for name in sorted(ours):
        n, names = out.get(calls[name], (0, []))
        if ours[name] != theirs[name]:
            names = names + [name]
        out[calls[name]] = (n + 1, names)
    return out


def write_epoch0(conf: str, dict_path: str, seed: int, out_dir: str,
                 calls: dict[str, str] | None = None
                 ) -> tuple[str, dict[str, torch.Tensor]]:
    """Write the draw as OUT/epoch_0.pt + epoch_0.json; returns the .pt
    path and the state dict (`calls` as `draw` takes it)."""
    state = draw(load_config(conf), len(load_dict(dict_path)), seed, calls)
    path = ckpt_lib.save_checkpoint(out_dir, "epoch_0", state,
                                    {"epoch": 0, "step": 0})
    return path, state


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("conf", help="train config (.json or .yaml)")
    p.add_argument("dict", help="the drive's data/dict.txt")
    p.add_argument("seed", type=int)
    p.add_argument("out_dir")
    p.add_argument("--per_tensor", metavar="FILE",
                   help="also write {name: sha256} of every tensor")
    p.add_argument("--against", metavar="FILE",
                   help="another host's --per_tensor file of the same "
                        "draw: print, for each group of in-place calls "
                        "that drew a tensor, how many differ, and which")
    args = p.parse_args(argv)
    calls: dict[str, str] = {}
    path, state = write_epoch0(args.conf, args.dict, args.seed,
                               args.out_dir, calls)
    if args.per_tensor:
        write_per_tensor(state, args.per_tensor)
    if args.against:
        with open(args.against, encoding="utf-8") as f:
            theirs = json.load(f)
        for group, (n, names) in differing(calls, tensor_sha256(state),
                                           theirs).items():
            which = "" if len(names) in (0, n) else ": " + ", ".join(names)
            print(f"{group or '(left as built)'}: {n} tensors, "
                  f"{len(names)} differ{which}", flush=True)
    digest = state_sha256(state)
    n_params = sum(v.numel() for v in state.values())
    print(f"{path}: seed {args.seed}, {len(state)} tensors, {n_params} "
          f"parameters, sha256 {digest}", flush=True)
    return digest


if __name__ == "__main__":
    main()
