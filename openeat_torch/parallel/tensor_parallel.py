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

Sequence parallelism (SP) shards the encoder block stack's time axis
over the model group: rank i of n holds frames [i*t, (i+1)*t) of T =
n*t (`TimeShard`). Its collectives act on dim 1 of [B, T, ...]:

- gather_time: all-gather of time forward. Its backward is a
  reduce-scatter (sum over the group, keep one's slice) where the ranks
  hold partial gradients of the gathered tensor (it feeds a
  column-parallel Dense, or keys and values that every rank's queries
  read), or takes one's slice where every rank computed the same whole
  gradient (`reduce_grad=False`: the replicated loss head after the
  stack, an MoE layer run on the whole time);
- scatter_time: its converse, reduce-scatter forward after a
  row-parallel Dense, all-gather backward;
- split_time: one's slice forward, all-gather backward (the stack's
  input, which the replicated embed made whole on every rank);
- halo_exchange: each rank's shard with `left` frames of rank i-1 in
  front and `right` frames of rank i+1 behind, zeros at the group's
  ends, as F.pad gives the unsharded conv; its backward sends each
  halo's gradient back and adds it to the neighbour's boundary frames;
- sum_grads: identity forward on the replicated parameters of the
  stack; backward one flat sum all-reduce of their gradients, which
  each rank computed from its own frames only.

Pipeline parallelism moves activations between neighbouring ranks of
the pipe group: shift_next hands each rank's tensor to rank i+1 (zeros
into rank 0) and shift_prev to rank i-1. The GPipe schedule
(openeat_torch/parallel/pipeline.py) runs its forward and backward
ticks itself and pairs them: a tick's activation hop goes forward by
shift_next, its gradient hop back by shift_prev. (An autograd Function
per hop would let autograd skip the backward of a hop whose output no
stage used, and the ranks' collectives would fall out of step.)

Every collective on a tensor is a sum all-reduce: the gathers, the halo
and the hops write the rank's part into zeros and sum. NCCL and gloo
both take a sum all-reduce of CUDA tensors, which is what lets two
ranks share one card over gloo. A group of None is the single-process path: each function
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

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors


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


# ---- sequence parallelism: the time axis over the model group

@dataclass(frozen=True)
class TimeShard:
    """Shard i of n of the time axis (dim 1), over `group`."""
    group: Any
    n: int
    i: int

    def local(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's slice of a tensor whole along `dim`."""
        t = x.shape[dim] // self.n
        return x.narrow(dim, self.i * t, t)


def _gather(x: torch.Tensor, sp: TimeShard) -> torch.Tensor:
    t = x.shape[1]
    full = x.new_zeros((x.shape[0], sp.n * t) + tuple(x.shape[2:]))
    full.narrow(1, sp.i * t, t).copy_(x)
    return _all_reduce(full, sp.group)


def _scatter(x: torch.Tensor, sp: TimeShard) -> torch.Tensor:
    return sp.local(_all_reduce(x.clone(), sp.group)).contiguous()


class _GatherTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp, reduce_grad):
        ctx.sp, ctx.reduce_grad = sp, reduce_grad
        return _gather(x, sp)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            return _scatter(g, ctx.sp), None, None
        return ctx.sp.local(g).contiguous(), None, None


class _ScatterTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return _scatter(x, sp)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.sp), None


class _SplitTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return sp.local(x).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.sp), None


class _HaloExchange(torch.autograd.Function):
    """[B, t, C] -> [B, left + t + right, C]. One sum all-reduce each
    way of a [n, B, left + right, C] table: slot i holds rank i's first
    `right` frames (rank i-1's right halo) and its last `left` frames
    (rank i+1's left halo); backward, the halos' gradients."""

    @staticmethod
    def forward(ctx, x, left, right, sp):
        ctx.left, ctx.right, ctx.sp = left, right, sp
        b, t, c = x.shape
        table = x.new_zeros((sp.n, b, right + left, c))
        table[sp.i, :, :right] = x[:, :right]
        table[sp.i, :, right:] = x[:, t - left:]
        table = _all_reduce(table, sp.group)
        lo = (table[sp.i - 1, :, right:] if sp.i > 0
              else x.new_zeros((b, left, c)))
        hi = (table[sp.i + 1, :, :right] if sp.i < sp.n - 1
              else x.new_zeros((b, right, c)))
        return torch.cat([lo, x, hi], dim=1)

    @staticmethod
    def backward(ctx, g):
        left, right, sp = ctx.left, ctx.right, ctx.sp
        b, tt, c = g.shape
        t = tt - left - right
        gx = g[:, left:left + t].clone()
        table = g.new_zeros((sp.n, b, left + right, c))
        table[sp.i, :, :left] = g[:, :left]
        table[sp.i, :, left:] = g[:, left + t:]
        table = _all_reduce(table, sp.group)
        if sp.i < sp.n - 1:      # my tail was rank i+1's left halo
            gx[:, t - left:] += table[sp.i + 1, :, :left]
        if sp.i > 0:             # my head was rank i-1's right halo
            gx[:, :right] += table[sp.i - 1, :, left:]
        return gx, None, None, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *params):
        ctx.group = group
        return tuple(p.view_as(p) for p in params)

    @staticmethod
    def backward(ctx, *grads):
        flat = _all_reduce(_flatten_dense_tensors(grads), ctx.group)
        return (None, *_unflatten_dense_tensors(flat, grads))


def gather_time(x: torch.Tensor, sp: TimeShard,
                reduce_grad: bool = True) -> torch.Tensor:
    return _GatherTime.apply(x, sp, reduce_grad)


def scatter_time(x: torch.Tensor, sp: TimeShard) -> torch.Tensor:
    return _ScatterTime.apply(x, sp)


def split_time(x: torch.Tensor, sp: TimeShard) -> torch.Tensor:
    return _SplitTime.apply(x, sp)


def halo_exchange(x: torch.Tensor, left: int, right: int,
                  sp: TimeShard) -> torch.Tensor:
    """x [B, t, C] with `left` frames of the rank before and `right` of
    the rank after (t >= left, right), zeros at the ends."""
    return _HaloExchange.apply(x, left, right, sp)


def sum_grads(params: list, group) -> tuple:
    """The parameters as they are; their gradients summed over the
    group in one all-reduce."""
    return _SumGrads.apply(group, *params)


# ---- pipeline parallelism: hops between neighbouring pipe ranks

def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    n, i = dist.get_world_size(group), dist.get_rank(group)
    table = x.new_zeros((n,) + tuple(x.shape))
    table[i] = x
    table = _all_reduce(table, group)
    src = i - step
    return table[src] if 0 <= src < n else torch.zeros_like(x)


def shift_next(x: torch.Tensor, group) -> torch.Tensor:
    """Rank i-1's x on rank i; zeros on rank 0. Every rank calls it."""
    return _shift(x, group, 1)


def shift_prev(x: torch.Tensor, group) -> torch.Tensor:
    """Rank i+1's x on rank i; zeros on the last rank."""
    return _shift(x, group, -1)


# ---- the data group's denominators and shares

def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of x (no gradient); x itself with no group."""
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
    group = dense.tp_group
    if dense.tp_mode == "row":
        y = reduce_from_group(dense.local(x), group)
        return y if dense.bias is None else \
            y + dense.bias.to(dense.compute_dtype)
    y = dense.local(copy_to_group(x, group))
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
