"""The ('data', 'model') mesh over torch.distributed ranks, the
tensor-parallel rules, and gathering a sharded model back. Port of
openeat_tpu/parallel/mesh.py.

Process model. The JAX package drives every chip of a host from one
process and lets GSPMD place the collectives. The port runs one process
per card, as PyTorch does: the entry points run under torchrun

    python -m torch.distributed.run --nproc_per_node N \\
        -m openeat_torch.bin.train --dp N ...

which sets RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR
and MASTER_PORT. `init_mesh` reads them and starts the process group:
NCCL on --device cuda (each rank on cuda:LOCAL_RANK), gloo on --device
cpu, with no fallback from one to the other. --dp N --tp M must give
N * M == WORLD_SIZE (ValueError otherwise); --dp -1 takes WORLD_SIZE //
M, the JAX remainder rule. Without a torchrun environment, dp = tp = 1
is the single-process path, unchanged, with no mesh at all; any other
layout raises rather than training one rank alone.

World rank = data_rank * tp + model_rank, the row-major device grid of
the JAX mesh, so a model group is tp consecutive ranks. The data group
(the ranks of one model rank) sums the gradients once per optimizer
step and the loss denominators; the model group shards the layers the
TP rules reach:

- FFN w_1 column-parallel and w_2 row-parallel, when the hidden width
  divides by tp;
- attention q/k/v/pos column-parallel over the heads and linear_out
  row-parallel, with pos_bias_u/v split by heads, when d_model and the
  head count divide by tp (JAX splits the columns whatever the heads;
  the port splits whole heads);
- embed vocab-parallel, ctc_lo and output_layer column-parallel with
  the logits gathered, when the vocab divides by tp. At the AIShell
  vocab of 4233 they stay replicated, as in JAX, and the vocab is not
  padded;
- the MoE expert banks by experts, when E divides by tp (the router
  stays replicated).

Everything else is replicated, the fine-tuning adapters too: JAX's
TP_RULES would split their down_proj and up_proj, which only moves the
same numbers; the port keeps them whole, since they are small and
sequence parallelism runs them on each rank's frames. Dropout masks:
the trainer seeds one generator per data rank, so the ranks of a model
group draw the same masks, and a dropout inside a sharded region draws
the whole mask and keeps its slice (modules/dropout.py).

Sequence parallelism: a model with `sequence_sharding` shards its
encoder block stack's time axis over the model group (apply_mesh gives
the stack its TimeShard; modules/encoder.py).

Pipeline parallelism has a mesh of its own, JAX's ('data', 'pipe')
(make_pipe_mesh): world rank = data_rank * pp + pipe_rank, tp = 1. On
it apply_mesh keeps on each pipe rank only the encoder layers its
stage applies (stage_model): a weight-shared layer whose applications
fall on two or more stages is kept on each of them. full_state_dict
and full_optimizer_state gather the stages back to the whole model's
tensors. The loss runs
through openeat_torch/parallel/pipeline.py.

With --multihost (the JAX package's one process per host) the ranks of
a node form one "process" of the JAX CLI: the loader shards batches by
node, each node pads its batch to a multiple of its data ranks, and the
global batch is node 0's rows, then node 1's, and so on.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from openeat_torch.modules.attention import (MultiHeadedAttention,
                                             RelPositionMultiHeadedAttention)
from openeat_torch.modules.feed_forward import (Adapter,
                                                MoEPositionwiseFeedForward,
                                                PositionwiseFeedForward)
from openeat_torch.modules.layers import Dense, Embed
from openeat_torch.parallel.tensor_parallel import TimeShard, all_gather_rows
from openeat_torch.utils.optim import trainable

COL, ROW = (None, "model"), ("model", None)
# openeat_tpu/parallel/mesh.py:TP_RULES: (regex over the flax parameter
# path 'a/b/c', partition spec); the first match wins
TP_RULES: list[tuple[str, tuple]] = [
    (r".*(feed_forward|feed_forward_macaron)/w_1/kernel$", COL),
    (r".*(feed_forward|feed_forward_macaron)/w_2/kernel$", ROW),
    (r".*(linear_q|linear_k|linear_v|linear_pos)/kernel$", COL),
    (r".*linear_out/kernel$", ROW),
    (r".*embed/embedding$", ROW),
    (r".*output_layer/kernel$", COL),
    (r".*ctc_lo/kernel$", COL),
    (r".*(down_proj)/kernel$", COL),
    (r".*(up_proj)/kernel$", ROW),
    (r".*feed_forward/w_in$", ("model", None, None)),
    (r".*feed_forward/w_out$", ("model", None, None)),
    (r".*feed_forward/b_in$", ("model", None)),
    (r".*feed_forward/b_out$", ("model", None)),
]


def param_spec(path: str) -> tuple:
    """The partition spec of a flax parameter path; () = replicated."""
    for pattern, spec in TP_RULES:
        if re.match(pattern, path):
            return spec
    return ()


@dataclass
class Mesh:
    dp: int
    tp: int
    data_rank: int
    model_rank: int
    data_group: Any
    model_group: Any     # None when tp == 1
    nodes: int = 1       # > 1 under --multihost
    pp: int = 1          # pipeline stages (make_pipe_mesh)
    pipe_rank: int = 0
    pipe_group: Any = None   # None when pp == 1

    @property
    def local_dp(self) -> int:
        """Data ranks on one node: the multiple a node's batch pads to."""
        return self.dp // self.nodes

    @property
    def node(self) -> int:
        return self.data_rank // self.local_dp

    def rows(self, n: int) -> slice:
        """This rank's rows of its node's batch of n rows (n a multiple
        of local_dp)."""
        k = n // self.local_dp
        j = self.data_rank % self.local_dp
        return slice(j * k, (j + 1) * k)


def resolve_layout(dp: int, tp: int, world: int) -> tuple[int, int]:
    """(dp, tp) for `world` ranks; dp -1 takes world // tp."""
    tp = max(1, tp)
    if dp == -1:
        dp = world // tp
    if dp < 1 or dp * tp != world:
        raise ValueError(f"--dp {dp} x --tp {tp} must equal the "
                         f"{world} ranks of WORLD_SIZE")
    return dp, tp


def _grid(dp: int, n: int) -> tuple[int, int, Any, Any]:
    """(data rank, inner rank, data group, inner group) of this rank on
    the row-major [dp, n] grid of the world's ranks; the inner group is
    None when n == 1. Every rank creates every group in the same
    order."""
    data_rank, inner_rank = divmod(dist.get_rank(), n)
    data_group = inner_group = None
    for m in range(n):
        g = dist.new_group([d * n + m for d in range(dp)])
        if m == inner_rank:
            data_group = g
    if n > 1:
        for d in range(dp):
            g = dist.new_group([d * n + m for m in range(n)])
            if d == data_rank:
                inner_group = g
    return data_rank, inner_rank, data_group, inner_group


def make_mesh(dp: int, tp: int, nodes: int = 1) -> Mesh:
    """The mesh over the initialised process group's ranks; every rank
    calls it."""
    dp, tp = resolve_layout(dp, tp, dist.get_world_size())
    if dp % nodes:
        raise ValueError(f"{dp} data ranks do not split over {nodes} nodes")
    return Mesh(dp, tp, *_grid(dp, tp), nodes)


def make_pipe_mesh(dp: int, pp: int) -> Mesh:
    """JAX's pipeline mesh ('data', 'pipe') over the process group's
    ranks: world rank = data_rank * pp + pipe_rank; every rank calls
    it."""
    world = dist.get_world_size()
    if dp < 1 or pp < 1 or dp * pp != world:
        raise ValueError(f"data {dp} x pipe {pp} must equal the {world} "
                         "ranks of the process group")
    data_rank, pipe_rank, data_group, pipe_group = _grid(dp, pp)
    return Mesh(dp, 1, data_rank, 0, data_group, None, pp=pp,
                pipe_rank=pipe_rank, pipe_group=pipe_group)


def init_mesh(dp: int | None, tp: int | None, device: torch.device,
              multihost: bool = False
              ) -> tuple[Mesh | None, torch.device]:
    """Start the process group from torchrun's environment and build the
    mesh; returns (mesh, this rank's device). Outside torchrun, dp = tp
    = 1 gives (None, device) and anything else raises ValueError."""
    dp = 1 if dp is None else dp
    tp = 1 if tp is None else tp
    if "WORLD_SIZE" not in os.environ:
        if multihost or dp not in (1, -1) or tp != 1:
            raise ValueError(
                f"--dp {dp} --tp {tp}{' --multihost' if multihost else ''}"
                " needs one process per rank: launch with python -m "
                "torch.distributed.run --nproc_per_node N ...")
        return None, device
    world = int(os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    resolve_layout(dp, tp, world)   # refuse it before the rendezvous
    nodes = world // local_world if multihost else 1
    if multihost and local_world % max(1, tp):
        raise ValueError(f"--tp {tp} must divide the {local_world} ranks "
                         "of a node")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            rank=int(os.environ["RANK"]), world_size=world)
    return make_mesh(dp, tp, nodes), device


def close_mesh(mesh: Mesh | None) -> None:
    if mesh is not None and dist.is_initialized():
        dist.destroy_process_group()


# ---- the model on the mesh

def tp_plan(model: nn.Module, tp: int) -> dict[str, str]:
    """{module path: how it shards} for the layers the TP rules reach at
    tp ranks: "ffn", "attention", "gather" (a column-parallel output
    layer), "vocab" (an embedding) or "experts". An adapter's layers
    stay replicated."""
    if tp <= 1:
        return {}
    plan, units = {}, []
    for name, m in model.named_modules():
        path = name.replace(".", "/")
        if isinstance(m, (PositionwiseFeedForward, MultiHeadedAttention,
                          MoEPositionwiseFeedForward, Adapter)):
            units.append(name + ".")
        if isinstance(m, PositionwiseFeedForward):
            if (param_spec(f"{path}/w_1/kernel") == COL
                    and param_spec(f"{path}/w_2/kernel") == ROW
                    and m.w_1.out_features % tp == 0):
                plan[name] = "ffn"
        elif isinstance(m, MultiHeadedAttention):
            if (param_spec(f"{path}/linear_q/kernel") == COL
                    and param_spec(f"{path}/linear_out/kernel") == ROW
                    and m.h % tp == 0):
                plan[name] = "attention"
        elif isinstance(m, MoEPositionwiseFeedForward):
            if (param_spec(f"{path}/w_in")[:1] == ("model",)
                    and m.num_experts % tp == 0):
                plan[name] = "experts"
        elif isinstance(m, Embed):
            if (param_spec(f"{path}/embedding") == ROW
                    and m.num_embeddings % tp == 0):
                plan[name] = "vocab"
        elif isinstance(m, Dense) and not name.startswith(tuple(units)):
            if (param_spec(f"{path}/kernel") == COL
                    and m.out_features % tp == 0):
                plan[name] = "gather"
    return plan


def _shard(module: nn.Module, name: str, dim: int, n: int, i: int) -> None:
    p = getattr(module, name)
    k = p.shape[dim] // n
    new = nn.Parameter(p.detach().narrow(dim, i * k, k).clone(),
                       requires_grad=p.requires_grad)
    new.tp_dim = dim
    setattr(module, name, new)


def _shard_dense(dense: Dense, mode: str, mesh: Mesh) -> None:
    n, i = mesh.tp, mesh.model_rank
    if mode == "row":
        _shard(dense, "weight", 1, n, i)
    else:
        _shard(dense, "weight", 0, n, i)
        if dense.bias is not None:
            _shard(dense, "bias", 0, n, i)
    dense.tp_mode, dense.tp_group = mode, mesh.model_group


def shard_model(model: nn.Module, mesh: Mesh) -> dict[str, str]:
    """Replace, in place, the parameters of every layer of
    tp_plan(model, mesh.tp) by this rank's shards (each marked with its
    `tp_dim`) and switch those layers to their sharded forwards. Run
    before the optimizer is built. Returns the plan."""
    n, i, group = mesh.tp, mesh.model_rank, mesh.model_group
    plan = tp_plan(model, n)
    for name, kind in plan.items():
        m = model.get_submodule(name)
        if kind == "ffn":
            _shard_dense(m.w_1, "column", mesh)
            _shard_dense(m.w_2, "row", mesh)
            m.dropout.shard = (-1, n, i)
        elif kind == "attention":
            for lin in ("linear_q", "linear_k", "linear_v", "linear_pos"):
                if hasattr(m, lin):
                    _shard_dense(getattr(m, lin), "column", mesh)
            _shard_dense(m.linear_out, "row", mesh)
            if isinstance(m, RelPositionMultiHeadedAttention):
                _shard(m, "pos_bias_u", 0, n, i)
                _shard(m, "pos_bias_v", 0, n, i)
            m.h //= n
            m.attn_dropout.shard = (1, n, i)
        elif kind == "experts":
            for p in ("w_in", "b_in", "w_out", "b_out"):
                _shard(m, p, 0, n, i)
            m.tp_group = group
            m.expert_offset = i * (m.num_experts // n)
            m.dropout.shard = (0, n, i)
        elif kind == "vocab":
            _shard(m, "weight", 0, n, i)
            m.tp_group = group
        else:
            _shard_dense(m, "gather", mesh)
    return plan


@dataclass
class PipeLayout:
    """The whole model's entries, kept by stage_model: the state_dict's
    names in order with their shapes and dtypes, the trainable
    parameters' names in the optimizer's order, and the stages that
    apply each physical encoder layer."""
    state: dict[str, tuple[torch.Size, torch.dtype]]
    params: list[str]
    owner: dict[int, tuple[int, ...]]

    def stage_of(self, name: str) -> int | None:
        """The stage whose copy of a state entry the gathers take (the
        first that holds it), or None (every stage)."""
        m = re.match(r"encoder\.encoders\.layer_(\d+)\.", name)
        return None if m is None else self.owner[int(m.group(1))][0]

    def shared(self) -> list[str]:
        """The state entries of the layers held on more than one stage,
        in state_dict order."""
        return [n for n in self.state
                if (m := re.match(r"encoder\.encoders\.layer_(\d+)\.", n))
                and len(self.owner[int(m.group(1))]) > 1]


def stage_owner(num_layers: int, share: int, pp: int
                ) -> dict[int, tuple[int, ...]]:
    """{physical encoder layer: the stages that apply it, in order} when
    the num_layers * share block applications split into pp contiguous
    stages (ValueError when they do not divide). A weight-shared layer
    whose applications span stages has each of them, as JAX's stack of
    one entry per application has (openeat_tpu/parallel/pipeline.py:
    stack_block_params)."""
    total = num_layers * share
    if total % pp:
        raise ValueError(f"{total} block applications not divisible by "
                         f"pipe={pp}")
    owner: dict[int, tuple[int, ...]] = {}
    for a in range(total):
        layer, stage = a // share, a // (total // pp)
        stages = owner.setdefault(layer, ())
        if stage not in stages:
            owner[layer] = stages + (stage,)
    return owner


def stage_model(model: nn.Module, mesh: Mesh) -> None:
    """Keep only the encoder layers this pipe rank applies (each
    parameter marked `pipe_stage`, and `pipe_copies`, the number of
    stages that hold it) and record the whole model's layout
    (`pipe_layout`)."""
    enc = model.encoder.encoders
    owner = stage_owner(enc.num_layers, enc.num_blocks_share, mesh.pp)
    model.pipe_layout = PipeLayout(
        {k: (v.shape, v.dtype) for k, v in model.state_dict().items()},
        [n for n, _ in model.named_parameters() if trainable(n)], owner)
    for layer, stages in owner.items():
        if mesh.pipe_rank not in stages:
            delattr(enc, f"layer_{layer}")
        else:
            for p in getattr(enc, f"layer_{layer}").parameters():
                p.pipe_stage = True
                p.pipe_copies = len(stages)


def apply_mesh(model: nn.Module, mesh: Mesh | None) -> None:
    """Point every module that keeps a `data_group` (the loss
    denominators, the MoE statistics) at the mesh's, shard the model
    over the model group (and its encoder's time axis, with
    `sequence_sharding`), and keep this rank's pipeline stage."""
    if mesh is None:
        return
    for m in model.modules():
        if hasattr(m, "data_group"):
            m.data_group = mesh.data_group
    if mesh.tp > 1:
        shard_model(model, mesh)
        if getattr(model, "sequence_sharding", False):
            model.encoder.encoders.time_shard = TimeShard(
                mesh.model_group, mesh.tp, mesh.model_rank)
    if mesh.pp > 1:
        stage_model(model, mesh)


def _gather(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    return torch.cat(list(all_gather_rows(t.detach(), mesh.model_group)),
                     dim=dim)


def _unstage(local: dict, like: dict, stage_of, mesh: Mesh,
             dev: torch.device) -> dict:
    """{name: tensor} over every name of `like` ({name: (shape, dtype,
    device)}, in order): this rank's `local` entries, and the entries of
    the staged layers (stage_of(name) not None) gathered over the pipe
    group: each from the stage stage_of names, zeros from the others,
    in one float32 sum all-reduce on `dev`."""
    staged = [n for n in like if stage_of(n) is not None]
    parts = [local[n].detach().float().to(dev)
             if n in local and stage_of(n) == mesh.pipe_rank
             else torch.zeros(like[n][0], device=dev) for n in staged]
    flat = _flatten_dense_tensors(parts)
    dist.all_reduce(flat, group=mesh.pipe_group)
    whole = dict(zip(staged, _unflatten_dense_tensors(flat, parts)))
    return {n: whole[n].to(dtype=like[n][1], device=like[n][2])
            if n in whole else local[n] for n in like}


def full_state_dict(model: nn.Module, mesh: Mesh | None) -> dict:
    """The model's state_dict with every shard gathered back to the full
    tensor, and every pipeline stage's layers to every rank: the
    checkpoint of a sharded or staged model is the whole one's."""
    state = model.state_dict()
    if mesh is not None and mesh.pp > 1:
        layout = model.pipe_layout
        dev = next(model.parameters()).device
        like = {n: (shape, dtype, dev)
                for n, (shape, dtype) in layout.state.items()}
        return _unstage(state, like, layout.stage_of, mesh, dev)
    if mesh is None or mesh.tp == 1:
        return state
    for name, p in model.named_parameters():
        if hasattr(p, "tp_dim"):
            state[name] = _gather(p, p.tp_dim, mesh)
    return state


def _optimizer_params(optimizer: torch.optim.Optimizer) -> list:
    return [p for g in optimizer.param_groups for p in g["params"]]


def _unstage_optimizer(state: dict, optimizer: torch.optim.Optimizer,
                       model: nn.Module, mesh: Mesh) -> dict:
    """A staged model's optimizer state indexed over the whole model's
    parameters (PipeLayout.params), the other stages' gathered."""
    layout = model.pipe_layout
    ids = {id(p): n for n, p in model.named_parameters()}
    mine = [ids[id(p)] for p in _optimizer_params(optimizer)]
    local = {(mine[i], k): v for i, entry in state["state"].items()
             for k, v in entry.items()}
    kinds = {}   # state key -> (param-shaped, its own shape, dtype, device)
    for (n, k), v in local.items():
        kinds.setdefault(k, (v.shape == layout.state[n][0], v.shape,
                             v.dtype, v.device))
    like = {(n, k): (layout.state[n][0] if shaped else shape, dtype, dev)
            for n in layout.params
            for k, (shaped, shape, dtype, dev) in kinds.items()}
    whole = (_unstage(local, like, lambda key: layout.stage_of(key[0]),
                      mesh, next(model.parameters()).device)
             if local else {})
    group = dict(state["param_groups"][0],
                 params=list(range(len(layout.params))))
    return {"state": {i: {k: whole[(n, k)] for k in kinds}
                      for i, n in enumerate(layout.params) if whole},
            "param_groups": [group]}


def full_optimizer_state(optimizer: torch.optim.Optimizer,
                         mesh: Mesh | None, model: nn.Module | None = None
                         ) -> dict:
    """optimizer.state_dict() with each sharded parameter's state tensors
    gathered to the full shape, so that a resume is exact at any tp;
    a staged `model`'s (pp > 1) indexed over the whole model's
    parameters, the other stages' gathered."""
    state = optimizer.state_dict()
    if mesh is not None and mesh.pp > 1:
        return _unstage_optimizer(state, optimizer, model, mesh)
    if mesh is None or mesh.tp == 1:
        return state
    for idx, p in enumerate(_optimizer_params(optimizer)):
        if hasattr(p, "tp_dim") and idx in state["state"]:
            state["state"][idx] = {
                k: _gather(v, p.tp_dim, mesh) if v.shape == p.shape else v
                for k, v in state["state"][idx].items()}
    return state


def shard_optimizer_state(state: dict, optimizer: torch.optim.Optimizer,
                          mesh: Mesh | None) -> dict:
    """The inverse of full_optimizer_state for this rank's shards."""
    if mesh is None or mesh.tp == 1:
        return state
    for idx, p in enumerate(_optimizer_params(optimizer)):
        if hasattr(p, "tp_dim") and idx in state["state"]:
            d, k = p.tp_dim, p.shape[p.tp_dim]
            state["state"][idx] = {
                key: v.narrow(d, mesh.model_rank * k, k).clone()
                if v.dim() == p.dim() and v.shape[d] == k * mesh.tp else v
                for key, v in state["state"][idx].items()}
    return state
