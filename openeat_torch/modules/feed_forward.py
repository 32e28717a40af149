"""Position-wise feed-forward blocks (PyTorch). Port of
openeat_tpu/modules/feed_forward.py: PositionwiseFeedForward (linear ->
activation -> dropout -> linear), MoEPositionwiseFeedForward and the
fine-tuning bottleneck Adapter.

Under tensor parallelism (openeat_torch/parallel/mesh.py) w_1 is
column-parallel, w_2 row-parallel and the dropout between them acts on
the hidden shard; the forward is the same code. Under sequence
parallelism (`sp`) a sharded FFN gathers time before w_1 and
reduce-scatters after w_2; a replicated one runs on the rank's frames.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from openeat_torch.modules.dropout import Dropout
from openeat_torch.modules.layers import Dense, LayerNorm
from openeat_torch.parallel import tensor_parallel as tp


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_model: int, hidden_units: int,
                 activation: Callable, dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.w_1 = Dense(d_model, hidden_units, dtype=dtype)
        self.w_2 = Dense(hidden_units, d_model, dtype=dtype)
        self.activation = activation
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor,
                sp: tp.TimeShard | None = None) -> torch.Tensor:
        if sp is None:
            return self.w_2(self.dropout(self.activation(self.w_1(x))))
        if self.w_2.tp_mode is None:
            h = self.activation(self.w_1(x))
            return self.w_2(self.dropout(h, (1, sp.n, sp.i)))
        h = self.activation(self.w_1.local(tp.gather_time(x, sp)))
        y = tp.scatter_time(self.w_2.local(self.dropout(h)), sp)
        return y + self.w_2.bias.to(y.dtype)


class MoEPositionwiseFeedForward(nn.Module):
    """Mixture-of-experts FFN: top-k routing with a static per-expert
    capacity and the Switch load-balance loss. Computes what the JAX
    module computes:

    - routing in float32 (router Dense on x in float32, softmax);
    - top-k by iterative argmax, pads (pad_mask False) routed nowhere,
      gates renormalised over the k selected;
    - capacity max(ceil(k * S / E * capacity_factor), k) with S = B*T
      tokens, pads included; each token's position in its expert's
      buffer in token order, tokens past the capacity dropped (output
      0, so the caller's residual passes them through);
    - aux = E * sum_e frac_e * p_mean_e over the valid tokens, frac_e
      the routed fraction (before drops) over k, p_mean_e the mean
      router probability.

    Returns (y [B, T, D] in the compute dtype, aux float32 scalar);
    the aux goes back to the loss rather than into a collection.

    PyTorch's idiom in place of the one-hot [S, E, C] einsums: kept
    (token, expert) pairs are written into [E, C, D] buffers, the experts
    run as two bmm, and each token gathers its k outputs back, weighted
    by its gates; dropped pairs go to a trash row. No scatter-add.

    Under data parallelism (`data_group`) the numbers are those of the
    global batch that the JAX mesh routes: S is the global token count,
    a rank's positions are offset by the routed counts of the lower data
    ranks (one all-reduce of a [dp, E + 2] table a call: counts, valid
    tokens, S), and the aux uses the global counts and a differentiable
    all-reduce of the probability sums. Under expert parallelism
    (openeat_torch/parallel/mesh.py: E % tp == 0) the banks hold experts
    [e0, e0 + E/tp) and the router stays replicated; each rank runs its
    experts on its data shard's tokens, which every model rank holds, and
    the combine is summed over the model group.
    """

    def __init__(self, d_model: int, hidden_units: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 activation: Callable = F.relu,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.num_experts = num_experts
        self.top_k = min(top_k, num_experts)
        self.capacity_factor = capacity_factor
        self.activation = activation
        self.compute_dtype = dtype
        self.router = Dense(d_model, num_experts, dtype=torch.float32)
        self.w_in = nn.Parameter(torch.zeros(num_experts, d_model,
                                             hidden_units))
        self.b_in = nn.Parameter(torch.zeros(num_experts, hidden_units))
        self.w_out = nn.Parameter(torch.zeros(num_experts, hidden_units,
                                              d_model))
        self.b_out = nn.Parameter(torch.zeros(num_experts, d_model))
        self.dropout = Dropout(dropout_rate)
        self.data_group = None
        self.tp_group = None     # set when the banks are expert-sharded
        self.expert_offset = 0   # the first expert this rank holds

    def capacity(self, tokens: int) -> int:
        k, e = self.top_k, self.num_experts
        return max(int(math.ceil(k * tokens / e * self.capacity_factor)), k)

    def route(self, x: torch.Tensor, pad_mask: torch.Tensor | None = None):
        """Routing of x [B, T, D]: (probs [S, E] f32, sel [S, E] f32 0/1
        before drops, keep [S, E] bool, pos [S, E] int64 each pair's
        local buffer slot, capacity, valid [S] f32, experts [S, k] in
        selection order, (routed counts [E], valid tokens) of the global
        batch)."""
        b, t, _ = x.shape
        s, e = b * t, self.num_experts
        if pad_mask is not None:
            valid = pad_mask.reshape(b, -1, t)[:, 0, :].reshape(s).float()
        else:
            valid = torch.ones(s, device=x.device)
        probs = torch.softmax(self.router(x.reshape(s, -1).float()), dim=-1)
        sel = torch.zeros_like(probs)
        masked = probs.detach()
        experts = []
        for _ in range(self.top_k):
            idx = masked.argmax(dim=-1)
            one = F.one_hot(idx, e).float()
            sel = sel + one
            masked = masked * (1.0 - one)
            experts.append(idx)
        sel = sel * valid[:, None]
        pos = sel.long().cumsum(dim=0) - 1
        counts = sel.sum(dim=0)
        n_valid = valid.sum()
        if self.data_group is None:
            offset = torch.zeros_like(pos[0])
            tokens, stats = s, (counts, n_valid)
        else:
            rows = tp.all_gather_rows(torch.cat([
                counts, n_valid[None], counts.new_full((1,), s)]),
                self.data_group)
            rank = torch.distributed.get_rank(self.data_group)
            offset = rows[:rank, :e].sum(dim=0).long()
            tokens = int(rows[:, e + 1].sum().item())
            stats = (rows[:, :e].sum(dim=0), rows[:, e].sum())
        cap = self.capacity(tokens)
        keep = (sel > 0) & (pos + offset < cap)
        return (probs, sel, keep, pos, cap, valid, torch.stack(experts, 1),
                stats)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        b, t, d = x.shape
        s = b * t
        probs, sel, keep, pos, cap, valid, experts, (counts, n_valid) = \
            self.route(x, pad_mask)
        k, e = self.top_k, self.num_experts
        gates = probs * sel
        gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True),
                                    min=1e-9)

        # aux over the valid tokens of the (global) batch
        n_valid = torch.clamp(n_valid, min=1.0)
        frac = counts / (k * n_valid)
        p_sum = (probs * valid[:, None]).sum(dim=0)
        p_sum = tp.all_reduce_sum(p_sum, self.data_group)
        aux = e * torch.sum(frac * (p_sum / n_valid))

        # dispatch the kept pairs this rank's experts serve
        e_local = self.w_in.shape[0]
        local = experts - self.expert_offset
        mine = keep.gather(1, experts) & (local >= 0) & (local < e_local)
        trash = e_local * cap
        dest = torch.where(mine, local * cap + pos.gather(1, experts), trash)
        dt = self.compute_dtype
        xc = tp.copy_to_group(x.reshape(s, d), self.tp_group).to(dt)
        buf = xc.new_zeros(trash + 1, d).index_put(
            (dest.reshape(-1),), xc[:, None].expand(s, k, d).reshape(-1, d))
        h = torch.bmm(buf[:trash].view(e_local, cap, d), self.w_in.to(dt)) \
            + self.b_in.to(dt)[:, None, :]
        h = self.dropout(self.activation(h))
        out = torch.bmm(h, self.w_out.to(dt)) + self.b_out.to(dt)[:, None, :]
        out = torch.cat([out.reshape(trash, d), out.new_zeros(1, d)])

        # combine: each token's k outputs weighted by its gates
        g = tp.copy_to_group(gates, self.tp_group).gather(1, experts)
        g = torch.where(mine, g, 0.0).to(dt)
        y = (g[..., None] * out[dest]).sum(dim=1)
        y = tp.reduce_from_group(y, self.tp_group)
        return y.reshape(b, t, d), aux


class Adapter(nn.Module):
    """Parameter-efficient fine-tuning bottleneck: scale * drop(up(drop(
    relu(down(LN(x)))))), with LayerNorm eps 1e-12 and both dropout
    sites of the JAX module (inside the bottleneck and on its output).
    `scalar` == -1 makes the scale a learned parameter `scale` [1]
    (initialised to ones). It returns the scaled update alone (the JAX
    module with residual=False, as its encoder and decoder layers build
    it), which the layer adds in parallel to its FFN branch. The
    parameters stay replicated under tensor parallelism (mesh.tp_plan
    skips them), and under sequence parallelism the adapter runs on the
    rank's frames with the whole dropout masks drawn (`shard`)."""

    def __init__(self, d_model: int, dropout_rate: float = 0.1,
                 down_size: int = 64, scalar: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = LayerNorm(d_model, 1e-12, dtype)
        self.down_proj = Dense(d_model, down_size, dtype=dtype)
        self.up_proj = Dense(down_size, d_model, dtype=dtype)
        self.dropout = Dropout(dropout_rate)
        self.out_dropout = Dropout(dropout_rate)
        self.learned_scale = scalar == -1
        if self.learned_scale:
            self.scale = nn.Parameter(torch.ones(1))
        # the fixed scale rounded to the compute dtype, as JAX casts it
        self.scalar = float(torch.tensor(scalar, dtype=dtype))

    def forward(self, x: torch.Tensor,
                shard: tuple[int, int, int] | None = None) -> torch.Tensor:
        h = F.relu(self.down_proj(self.norm(x)))
        h = self.up_proj(self.dropout(h, shard))
        h = self.out_dropout(h, shard)
        return (self.scale.to(h.dtype) * h if self.learned_scale
                else self.scalar * h)
