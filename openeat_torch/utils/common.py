"""Shared numeric helpers (PyTorch).

Port of openeat_tpu/utils/common.py: IGNORE_ID conventions, sos/eos
padding, sequence reversal, token accuracy, activations, log-add and
the CTC collapse, plus the device rule every entry point follows and the
seeded generators that stand in for the JAX package's PRNG keys.
"""

from __future__ import annotations

import logging
import math
import sys
from typing import Callable

import torch
import torch.nn.functional as F

from openeat_torch.parallel.tensor_parallel import global_sum

IGNORE_ID = -1


def resolve_device(name: str) -> torch.device:
    """Entry points run on CUDA unless the caller asks for the CPU.

    A CUDA request on a machine without a CUDA device raises instead of
    carrying on quietly on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False; pass --device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device


def make_generator(seed: int, device: torch.device | str = "cpu"
                   ) -> torch.Generator:
    """A torch.Generator on `device` seeded with `seed`: the port's
    stand-in for openeat_tpu/utils/common.py:train_prng. Every random
    draw of training (dropout, SpecAugment, batch order) takes one of
    these; nothing draws from the global RNG. The bits differ from
    JAX's, so parity tests inject JAX's draws instead."""
    return torch.Generator(device=device).manual_seed(int(seed))


LOG_FORMAT = "%(asctime)s %(levelname)s [%(filename)s:%(lineno)d] %(message)s"


def init_logger(name: str = "openeat_torch",
                level: int = logging.INFO) -> logging.Logger:
    """Console logger on stderr."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    if not logger.handlers:
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(logging.Formatter(LOG_FORMAT))
        logger.addHandler(sh)
    return logger


def add_sos_eos(ys_pad: torch.Tensor, ys_lens: torch.Tensor, sos: int,
                eos: int, ignore_id: int = IGNORE_ID
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """ys_pad [B, L] (ignore_id padded) -> (ys_in, ys_out), each [B, L+1]:
    ys_in = [sos, y1..yL, eos-fill], ys_out = [y1..yL, eos, ignore-fill]."""
    b, l = ys_pad.shape
    lens = ys_lens.long()[:, None]
    pos = torch.arange(l + 1, device=ys_pad.device)[None, :]
    ys_ext = torch.cat([ys_pad, ys_pad.new_full((b, 1), ignore_id)], dim=1)
    shifted = torch.cat([ys_pad.new_full((b, 1), sos), ys_ext[:, :-1]],
                        dim=1)
    ys_in = torch.where(pos == 0, sos,
                        torch.where(pos <= lens, shifted, eos))
    ys_out = torch.where(pos < lens, ys_ext,
                         torch.where(pos == lens, eos, ignore_id))
    return ys_in, ys_out


def reverse_pad_list(ys_pad: torch.Tensor, ys_lens: torch.Tensor,
                     pad_value: int = IGNORE_ID) -> torch.Tensor:
    """[y1..yL, pad...] -> [yL..y1, pad...] per row."""
    l = ys_pad.shape[1]
    pos = torch.arange(l, device=ys_pad.device)[None, :]
    lens = ys_lens.long()[:, None]
    src = (lens - 1 - pos).clamp(0, l - 1)
    return torch.where(pos < lens, ys_pad.gather(1, src), pad_value)


def th_accuracy(logits: torch.Tensor, target: torch.Tensor,
                ignore_label: int = IGNORE_ID, group=None) -> torch.Tensor:
    """Padding-masked token accuracy. logits [B, L, V]; target [B, L].
    With a data `group`: this rank's correct tokens over the group's
    total, its share of the global accuracy."""
    pred = logits.reshape(-1, logits.shape[-1]).argmax(dim=-1)
    target = target.reshape(-1)
    mask = target != ignore_label
    correct = (mask & (pred == target)).sum()
    return correct.float() / global_sum(mask.sum(), group).clamp(
        min=1).float()


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation registry with the JAX package's definitions (its gelu
    is the tanh approximation)."""
    acts = {
        "hardtanh": F.hardtanh,
        "tanh": torch.tanh,
        "relu": F.relu,
        "selu": F.selu,
        "swish": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
    }
    if name not in acts:
        raise ValueError(f"unknown activation {name!r}; have {sorted(acts)}")
    return acts[name]


def log_add(args) -> float:
    """Stable log-sum-exp over a python iterable."""
    xs = list(args)
    if all(a == -float("inf") for a in xs):
        return -float("inf")
    a_max = max(xs)
    return a_max + math.log(sum(math.exp(a - a_max) for a in xs))


def remove_duplicates_and_blank(hyp, blank_id: int = 0) -> list:
    """CTC collapse on a python sequence: dedupe runs, drop blanks."""
    out = []
    prev = None
    for t in hyp:
        t = int(t)
        if t != prev and t != blank_id:
            out.append(t)
        prev = t
    return out


def ctc_collapse(tokens: torch.Tensor, blank_id: int = 0,
                 pad_value: int = IGNORE_ID, return_positions: bool = False):
    """Batched CTC collapse. tokens [B, T] -> [B, T]: tokens that differ
    from their predecessor and are neither blank nor pad, compacted to
    the front in order, the rest `pad_value`. With return_positions,
    also each kept token's frame [B, T] (0 on pad lanes)."""
    b, t = tokens.shape
    prev = torch.cat([tokens.new_full((b, 1), -1), tokens[:, :-1]], dim=1)
    keep = (tokens != prev) & (tokens != blank_id) & (tokens != pad_value)
    pos = torch.arange(t, device=tokens.device)[None, :].expand(b, t)
    order = torch.argsort(torch.where(keep, pos, t + pos), dim=1)
    kept = keep.gather(1, order)
    out = torch.where(kept, tokens.gather(1, order), pad_value)
    if not return_positions:
        return out
    return out, torch.where(kept, order, 0)
