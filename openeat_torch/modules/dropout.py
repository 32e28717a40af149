"""Dropout at the exact rate, drawn from a generator the trainer owns.

Port of openeat_tpu/modules/dropout.py. The JAX module draws one random
byte per element and so realises a keep probability rounded to q/256
(rate 0.1 keeps 230/256); this port keeps exactly 1 - rate and scales by
1 / (1 - rate). A mask is drawn only in ``model.train()`` and only from
the ``torch.Generator`` that :func:`set_generator` hands every Dropout
of a model (and the encoder's dynamic chunk draw); training without one
raises rather than touching the global RNG.

A Dropout on an activation that tensor or sequence parallelism shards
(`shard` = (dim, n, i): this rank holds slice i of n along dim) draws
the whole activation's mask and keeps its slice. Every rank of a model
group then draws the same numbers in the same order, so their
generators stay in step and the replicated activations get the same
masks on every rank.
"""

from __future__ import annotations

import torch
from torch import nn


class Dropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate {rate} not in [0, 1)")
        self.rate = float(rate)
        self.generator: torch.Generator | None = None
        self.shard: tuple[int, int, int] | None = None

    def forward(self, x: torch.Tensor,
                shard: tuple[int, int, int] | None = None) -> torch.Tensor:
        """`shard` (dim, n, i) stands for the module's own for one call:
        sequence parallelism shards time only in some calls."""
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in training mode needs a generator; "
                               "call openeat_torch.modules.dropout."
                               "set_generator(model, generator)")
        shard = self.shard if shard is None else shard
        shape = list(x.shape)
        if shard is not None:
            dim, n, i = shard
            shape[dim] *= n
        u = torch.rand(shape, generator=self.generator, device=x.device)
        if shard is not None:
            u = u.narrow(dim, i * x.shape[dim], x.shape[dim])
        keep = u >= self.rate
        scale = 1.0 / (1.0 - self.rate)
        return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def set_generator(model: nn.Module, generator: torch.Generator | None,
                  chunk_generator: torch.Generator | None = None) -> None:
    """Point every module of `model` that draws in training at
    `generator` (the modules with a `generator` attribute: each Dropout,
    and the ASR model, whose pipeline-parallel loss derives its streams
    from it), and the encoder's dynamic chunk draw at `chunk_generator`,
    or at `generator` when it is None. Under data parallelism the
    trainer gives every data rank one chunk generator, seeded alike, and
    each its own dropout generator."""
    for m in model.modules():
        if hasattr(m, "generator"):
            m.generator = generator
        if hasattr(m, "chunk_generator"):
            m.chunk_generator = (generator if chunk_generator is None
                                 else chunk_generator)
