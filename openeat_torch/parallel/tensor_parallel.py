"""Tensor- and expert-parallel pieces: the collectives as autograd
Functions, and the sharded forwards of the layers the TP rules reach.

The JAX package shards parameters by annotation and lets GSPMD insert
the collectives (openeat_tpu/parallel/mesh.py). The port holds each
rank's shard as a plain tensor and places the collectives itself, as
Megatron-LM does:

- copy_to_group: identity forward, sum all-reduce of the gradient
  backward. It sits where a replicated activation enters a sharded
  region, whose ranks each hold part of the input's gradient;
- reduce_from_group: sum all-reduce forward, identity backward. It ends
  a row-parallel product (each rank's partial sum over its input slice)
  and the expert-parallel combine;
- gather_from_group: each rank's slice of the last dimension forward
  (column-parallel logits over a vocab shard), all ranks' slices
  concatenated; backward takes the rank's slice of the gradient;
- all_reduce_sum: sum all-reduce both ways, for a sum that every rank
  then uses whole (the MoE aux loss's probability sums over the data
  group).

Every collective on a tensor is a sum all-reduce: the gather writes the
rank's slice into zeros and sums. NCCL and gloo both take a sum
all-reduce of CUDA tensors, which is what lets two ranks share one card
over gloo. A group of None is the single-process path: each function
returns its input untouched.

A column-parallel Dense holds rows [i*out/n, (i+1)*out/n) of its weight
[out, in] and of its bias; a row-parallel one holds columns [i*in/n,
(i+1)*in/n) and the whole bias, which it adds once, after the reduce.
The vocab-parallel Embed holds rows of its table, zeroes the lookups of
ids outside them, and sums over the group.

The data group's helpers sit here too. Under data parallelism every
metric a model returns is the rank's share of the global batch's value:
a loss is the rank's sum over its rows divided by the global
denominator (the global batch size, or the global token count under
length_normalized_loss), so the data group's sum is the loss the JAX
mesh computes over the whole batch, and so is the sum of the ranks'
gradients. A value every data rank computes whole (the MoE aux loss)
enters as its 1/dp share.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        i = dist.get_rank(group)
        k = x.shape[-1]
        ctx.slot = (i * k, k)
        full = x.new_zeros(x.shape[:-1] + (n * k,))
        full.narrow(-1, i * k, k).copy_(x)
        return _all_reduce(full, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, *ctx.slot).contiguous(), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _GatherFromGroup.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, forward and backward: the gradient of a value
    every rank computes from the sum goes back to every addend."""
    return x if group is None else _AllReduce.apply(x, group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[n, *x.shape]: every rank's x (no gradient), by a sum all-reduce
    of zero-padded slots."""
    n = dist.get_world_size(group)
    full = x.new_zeros((n,) + tuple(x.shape))
    full[dist.get_rank(group)] = x
    return _all_reduce(full, group)


# ---- the data group's denominators and shares

def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The data group's sum of x (no gradient); x itself with no
    group."""
    return x if group is None else _all_reduce(x.detach().clone(), group)


def global_count(n: int, group) -> int:
    """The data group's sum of a host integer."""
    if group is None:
        return n
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    return int(_all_reduce(torch.tensor([n], device=dev), group).item())


def share(x: torch.Tensor, group) -> torch.Tensor:
    """A value every data rank holds whole, as this rank's share."""
    return x if group is None else x / dist.get_world_size(group)


# ---- the sharded layers' forwards (modules/layers.py dispatches here)

def dense_forward(dense, x: torch.Tensor) -> torch.Tensor:
    """Forward of a sharded Dense: tp_mode "column" (output sharded),
    "gather" (column, then the full output on every rank) or "row"
    (input sharded; the bias once, after the sum)."""
    dt = dense.compute_dtype
    group = dense.tp_group
    w = dense.dense_weight()
    if dense.tp_mode == "row":
        y = reduce_from_group(F.linear(x.to(dt), w), group)
        return y if dense.bias is None else y + dense.bias.to(dt)
    bias = None if dense.bias is None else dense.bias.to(dt)
    y = F.linear(copy_to_group(x, group).to(dt), w, bias)
    return gather_from_group(y, group) if dense.tp_mode == "gather" else y


def embed_forward(embed, ids: torch.Tensor) -> torch.Tensor:
    """Vocab-parallel lookup: this rank's rows [lo, lo + V/n) answer
    their ids, the others give zeros, and the group sums (exactly: one
    nonzero term a row)."""
    rows = embed.weight.shape[0]
    lo = dist.get_rank(embed.tp_group) * rows
    local = ids - lo
    outside = (local < 0) | (local >= rows)
    out = F.embedding(torch.where(outside, 0, local), embed.weight)
    out = torch.where(outside[..., None], 0.0, out)
    return reduce_from_group(out, embed.tp_group).to(embed.compute_dtype)


def embed_attend(embed, x: torch.Tensor) -> torch.Tensor:
    """Tied output head over a vocab-sharded table: the full logits."""
    dt = embed.compute_dtype
    y = F.linear(copy_to_group(x, embed.tp_group).to(dt),
                 embed.weight.to(dt))
    return gather_from_group(y, embed.tp_group)
