"""Checkpoints (PyTorch). Port of openeat_tpu/utils/checkpoint.py.

- save_checkpoint: the model's state_dict as ``<tag>.pt`` plus its info
  (epoch, step, lr, cv loss, ...) as ``<tag>.json``; the JAX package
  writes an orbax directory and ``<tag>.yaml``, and this port writes
  JSON because PyYAML is not a dependency of the port.
- save_optimizer / load_optimizer: the rolling ``optimizer.pt`` (Adam's
  state, the applied-update count, epoch and step) that makes a resume
  exact.
- load_trained_modules: partial init from another checkpoint, copying
  the entries whose key starts with one of the module prefixes
  (``--init_mods``, e.g. "encoder.,ctc.,decoder.") and whose shape
  matches.
Checkpoint averaging (bin/average_model.py) comes with a later slice.
"""

from __future__ import annotations

import json
import os

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


def save_optimizer(exp_dir: str, optimizer: torch.optim.Optimizer,
                   n_applied: int, epoch: int, step: int) -> str:
    path = os.path.join(exp_dir, "optimizer.pt")
    torch.save({"optimizer": optimizer.state_dict(), "n_applied": n_applied,
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
