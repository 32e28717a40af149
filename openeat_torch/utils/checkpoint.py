"""Checkpoints (PyTorch). Port of openeat_tpu/utils/checkpoint.py.

- save_checkpoint: the model's state_dict as ``<tag>.pt`` plus its info
  (epoch, step, lr, cv loss, ...) as ``<tag>.json``; the JAX package
  writes an orbax directory and ``<tag>.yaml``, and this port writes
  JSON because PyYAML is not a dependency of the port.
- save_optimizer / load_optimizer: the rolling ``optimizer.pt`` (Adam's
  state, the applied-update count, epoch and step) that makes a resume
  exact. On a mesh the first rank writes both files, with every shard
  gathered back (openeat_torch/parallel/mesh.py: full_state_dict and
  full_optimizer_state), so the files are the same at any layout.
- load_trained_modules: partial init from another checkpoint, copying
  the entries whose key starts with one of the module prefixes
  (``--init_mods``, e.g. "encoder.,ctc.,decoder.") and whose shape
  matches;
- find_epoch_checkpoints / average_checkpoints: the mean of the N best
  ``epoch_N.pt`` by the ``cv_loss`` in their ``.json`` (val_best) or of
  the last N in an epoch range, summed in float64 in the chosen order,
  divided by N and cast to float32, as the JAX package averages
  (bin/average_model.py).
"""

from __future__ import annotations

import json
import os
import re

import torch


def save_checkpoint(exp_dir: str, tag: str, state_dict: dict,
                    info: dict | None = None) -> str:
    """Write <exp_dir>/<tag>.pt (and <tag>.json); returns the .pt path."""
    os.makedirs(exp_dir, exist_ok=True)
    path = os.path.join(exp_dir, f"{tag}.pt")
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)
    if info is not None:
        with open(os.path.join(exp_dir, f"{tag}.json"), "w") as f:
            json.dump(info, f, indent=1)
    return path


def load_checkpoint(path: str) -> tuple[dict, dict]:
    """(state_dict on the CPU, info) from a .pt and its sibling .json."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    info_path = os.path.splitext(path)[0] + ".json"
    info = {}
    if os.path.exists(info_path):
        with open(info_path) as f:
            info = json.load(f)
    return state, info


def save_optimizer(exp_dir: str, optimizer_state: dict, n_applied: int,
                   epoch: int, step: int) -> str:
    """Write optimizer.pt from an optimizer's state_dict()."""
    path = os.path.join(exp_dir, "optimizer.pt")
    torch.save({"optimizer": optimizer_state, "n_applied": n_applied,
                "epoch": epoch, "step": step}, path)
    return path


def load_optimizer(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_trained_modules(target: dict, source: dict, init_mods: list[str]
                         ) -> tuple[dict, list[str]]:
    """Copy into `target` every `source` entry under one of the dotted
    module prefixes whose shape matches. Returns (new state_dict, the
    keys copied)."""
    mods = [m.strip().rstrip(".") for m in init_mods if m.strip()]
    new = dict(target)
    copied = []
    for key, value in target.items():
        if key in source and source[key].shape == value.shape and any(
                key == m or key.startswith(m + ".") for m in mods):
            new[key] = source[key].to(value.dtype)
            copied.append(key)
    return new, copied


def find_epoch_checkpoints(exp_dir: str) -> list[tuple[int, str]]:
    """(epoch, path) of every epoch_N.pt in exp_dir, by epoch."""
    out = []
    for name in os.listdir(exp_dir):
        m = re.fullmatch(r"epoch_(\d+)\.pt", name)
        if m:
            out.append((int(m.group(1)), os.path.join(exp_dir, name)))
    return sorted(out)


def average_checkpoints(exp_dir: str, num: int = 5, val_best: bool = True,
                        min_epoch: int = 0, max_epoch: int = 10 ** 9
                        ) -> dict[str, torch.Tensor]:
    """Average N checkpoints of [min_epoch, max_epoch]: with val_best the
    N of lowest cv_loss (a missing one counts as inf; ties by epoch),
    otherwise the last N. Floating entries are summed in float64, then
    divided by N and cast to float32; any other entry is the last
    chosen checkpoint's."""
    cands = [(e, p) for e, p in find_epoch_checkpoints(exp_dir)
             if min_epoch <= e <= max_epoch]
    if not cands:
        raise FileNotFoundError(f"no epoch_N.pt checkpoints in {exp_dir}")
    if val_best:
        scored = []
        for e, p in cands:
            info = load_checkpoint(p)[1]
            scored.append((float(info.get("cv_loss", float("inf"))), e, p))
        chosen = [p for _, _, p in sorted(scored)[:num]]
    else:
        chosen = [p for _, p in cands[-num:]]
    acc: dict[str, torch.Tensor] = {}
    for p in chosen:
        for k, v in load_checkpoint(p)[0].items():
            if v.is_floating_point():
                v = v.double()
                acc[k] = acc[k] + v if k in acc else v
            else:
                acc[k] = v
    n = len(chosen)
    return {k: (v / n).float() if v.is_floating_point() else v
            for k, v in acc.items()}
