"""GPipe pipeline parallelism (PP) over the mesh's pipe group. Port of
openeat_tpu/parallel/pipeline.py: make_pp_loss_fn, whose loss the train
step takes as build_train_step(..., loss_fn=make_pp_loss_fn(...),
mesh=mesh).

The encoder's block applications (a weight-shared stack repeats a
physical layer) split into `pp` contiguous stages; on a pipe mesh
(mesh.make_pipe_mesh) apply_mesh keeps on each pipe rank only its
stage's layers, the memory PP exists for. Everything outside the block
stack (CMVN and the subsampling embed, after_norm, CTC and the decoders)
is replicated over the pipe group and split over the data group as in
the plain step. The loss is the JAX one's:

- the head (model.pipeline_head) runs on every pipe rank; stage 0 feeds
  the pipeline from it;
- GPipe with `num_micro` microbatches of the rank's rows: the forward
  takes M + S - 1 ticks, stage s running its blocks on microbatch
  t - s at tick t, and after each tick every stage hands its output to
  the next (tensor_parallel.shift_next); the backward runs the ticks in
  reverse, each stage taking its output's gradient from the next stage
  (shift_prev) and running autograd over its own blocks. The schedule
  runs both directions itself, inside one autograd Function, so that
  every rank makes the same collectives in the same order;
- default tail: the last stage's finished microbatches go to every pipe
  rank (a sum over the pipe group, JAX's psum of its buffer), which runs
  model.pipeline_tail replicated;
- `tail_on_last_stage`: the tail runs on the last stage only, inside
  the Function, and only its metrics cross the pipe group. Each metric
  is the data rank's share of the global batch's value, as in the plain
  step, so the data group's sum is exact under length_normalized_loss
  too, where JAX's tail normalises per data shard
  (openeat_tpu/parallel/pipeline.py:235).

Gradients: a stage's block gradients stay on its rank, except those
of a weight-shared layer whose applications span stages, which each of
those stages holds (mesh.stage_owner): each stage's backward gives the
gradient of its own applications, and the backward sums them over the
pipe group (zeros from the stages that do not hold the layer), so
that every holder ends with the layer's whole gradient, the sum over
its applications that JAX's autodiff forms over its stack of one entry
per application. The replicated parameters' gradients end equal on
every pipe rank: the gradient of the
head's output (stage 0's) is summed over the pipe group, so that every
rank runs the head's backward with it, and with `tail_on_last_stage`
the tail's parameter gradients are summed over the group (zeros from
the other stages). The train step's global norm counts each parameter
once (parallel/train_step.py).

Dropout: one number drawn from the step's generator (model.generator)
seeds a stream for the head, one per (microbatch, stage) and one for
the tail, so every pipe rank draws alike; the trainer's generator folds
the data rank in, for the tail too (JAX's tail key is the same on every
data shard, openeat_tpu/parallel/pipeline.py:308).

Refused, as in JAX: mixture-of-experts layers, chunk masks and dynamic
chunks; and a mesh with a model group (the pipe mesh has none).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from openeat_torch.modules.dropout import set_generator
from openeat_torch.parallel import tensor_parallel as tp
from openeat_torch.parallel.mesh import Mesh
from openeat_torch.utils.common import make_generator
from openeat_torch.utils.mask import make_non_pad_mask


class _Streams:
    """Dropout generators derived from one draw of the step's
    generator; every part is None when it is None."""

    def __init__(self, generator: torch.Generator | None):
        self.device = None if generator is None else generator.device
        self.base = None if generator is None else int(torch.randint(
            2 ** 62, (), generator=generator, device=generator.device))

    def __call__(self, *key: int) -> torch.Generator | None:
        if self.base is None:
            return None
        seed = np.random.SeedSequence([self.base, *key]).generate_state(1)[0]
        return make_generator(seed, self.device)


HEAD, BLOCKS, TAIL = 0, 1, 2


class _Schedule:
    """This rank's stage and one step's inputs to it."""

    def __init__(self, layers: list, mesh: Mesh, num_micro: int, mask_pad,
                 pos_emb, streams: _Streams, shared: list):
        self.layers, self.mesh, self.m = layers, mesh, num_micro
        self.s, self.n = mesh.pipe_rank, mesh.pp
        self.masks = mask_pad.chunk(num_micro)
        self.pos_emb, self.streams = pos_emb, streams
        self.shared = shared

    def stage(self, x: torch.Tensor, m: int) -> torch.Tensor:
        """This stage's blocks on microbatch m."""
        gen = self.streams(BLOCKS, m, self.s)
        for layer in self.layers:
            set_generator(layer, gen)
            x = layer(x, self.masks[m], self.pos_emb, self.masks[m])
        return x

    def forward(self, xs: torch.Tensor) -> list:
        """The forward ticks: (inputs, outputs) of this stage's
        microbatches, with their graphs."""
        fresh = xs.detach().chunk(self.m)
        inputs, outputs = [None] * self.m, [None] * self.m
        received = None
        ticks = self.m + self.n - 1
        for t in range(ticks):
            m = t - self.s
            send = torch.zeros_like(fresh[0])
            if 0 <= m < self.m:
                x = (fresh[m] if self.s == 0 else received).detach()
                x.requires_grad_(True)
                with torch.enable_grad():
                    outputs[m] = self.stage(x, m)
                inputs[m] = x
                send = outputs[m].detach()
            if self.n > 1 and t < ticks - 1:
                received = tp.shift_next(send, self.mesh.pipe_group)
        return inputs, outputs

    def backward(self, inputs: list, outputs: list, grads: list | None
                 ) -> torch.Tensor:
        """The backward ticks, given the last stage's output gradients
        (a list over microbatches; None elsewhere). Returns the gradient
        of the head's output, summed over the pipe group."""
        first = [None] * self.m
        ticks = self.m + self.n - 1
        send = received = None
        earlier = [None if p is None else p.grad for p, _ in self.shared]
        for p, _ in self.shared:
            if p is not None:
                p.grad = None
        for t in reversed(range(ticks)):
            if self.n > 1 and t < ticks - 1:
                received = tp.shift_prev(send, self.mesh.pipe_group)
            m = t - self.s
            send = torch.zeros_like(inputs[0])
            if 0 <= m < self.m:
                g = grads[m] if self.s == self.n - 1 else received
                torch.autograd.backward(outputs[m], g)
                send = inputs[m].grad
                if self.s == 0:
                    first[m] = send
        self._sum_shared(earlier, inputs[0].device)
        dx = torch.cat(first) if self.s == 0 else torch.zeros_like(
            torch.cat(inputs))
        return tp.global_sum(dx, self.mesh.pipe_group)

    def _sum_shared(self, earlier: list, device: torch.device) -> None:
        """Sum this backward's gradients of the layers held on several
        stages over the pipe group and add them to what those
        parameters held before it (`earlier`, e.g. an accumulated
        micro-batch's)."""
        if not self.shared:
            return
        parts = [torch.zeros(shape, device=device)
                 if p is None or p.grad is None else p.grad
                 for p, shape in self.shared]
        flat = tp.global_sum(_flatten_dense_tensors(parts),
                             self.mesh.pipe_group)
        for (p, _), g, old in zip(self.shared,
                                  _unflatten_dense_tensors(flat, parts),
                                  earlier):
            if p is not None:
                p.grad = g if old is None else old + g


class _Pipeline(torch.autograd.Function):
    """xs [B, T, D] (the head's output) -> the block stack's output on
    every pipe rank."""

    @staticmethod
    def forward(ctx, xs, sched: _Schedule):
        inputs, outputs = sched.forward(xs)
        ctx.sched, ctx.inputs, ctx.outputs = sched, inputs, outputs
        last = sched.s == sched.n - 1
        out = torch.cat([o.detach() for o in outputs]) if last \
            else torch.zeros_like(xs)
        return tp.global_sum(out, sched.mesh.pipe_group)

    @staticmethod
    def backward(ctx, g):
        sched = ctx.sched
        grads = g.chunk(sched.m) if sched.s == sched.n - 1 else None
        return sched.backward(ctx.inputs, ctx.outputs, grads), None


class _PipelineTail(torch.autograd.Function):
    """xs -> the tail's metrics vector, computed on the last stage and
    summed over the pipe group (zeros from the other stages)."""

    @staticmethod
    def forward(ctx, xs, sched: _Schedule, tail, params: list, width: int):
        inputs, outputs = sched.forward(xs)
        ctx.sched, ctx.inputs, ctx.outputs = sched, inputs, outputs
        ctx.params = params
        vec = xs.new_zeros((width,), dtype=torch.float32)
        if sched.s == sched.n - 1:
            x = torch.cat([o.detach() for o in outputs]).requires_grad_()
            with torch.enable_grad():
                ctx.tail_vec = tail(x)
            ctx.tail_in = x
            vec = ctx.tail_vec.detach()
        return tp.global_sum(vec, sched.mesh.pipe_group)

    @staticmethod
    def backward(ctx, g):
        sched, params = ctx.sched, ctx.params
        last = sched.s == sched.n - 1
        if last:
            got = torch.autograd.grad(ctx.tail_vec, [ctx.tail_in] + params,
                                      g, allow_unused=True)
            dx = got[0]
            pgrads = [torch.zeros_like(p) if d is None else d
                      for p, d in zip(params, got[1:])]
        else:
            pgrads = [torch.zeros_like(p) for p in params]
        flat = tp.global_sum(_flatten_dense_tensors(pgrads),
                             sched.mesh.pipe_group)
        for p, d in zip(params, _unflatten_dense_tensors(flat, pgrads)):
            p.grad = d.clone() if p.grad is None else p.grad + d
        grads = dx.chunk(sched.m) if last else None
        return (sched.backward(ctx.inputs, ctx.outputs, grads), None, None,
                None, None)


def _stage_layers(model: nn.Module, mesh: Mesh) -> list:
    """The layers of this pipe rank's block applications, in order."""
    enc = model.encoder.encoders
    share = enc.num_blocks_share
    per = enc.num_layers * share // mesh.pp
    first = mesh.pipe_rank * per
    return [getattr(enc, f"layer_{a // share}")
            for a in range(first, first + per)]


def _shared_parameters(model: nn.Module) -> list:
    """(parameter or None, shape) of every entry of the layers held on
    more than one stage, in the same order on every pipe rank; None
    where this rank does not hold the layer."""
    layout = getattr(model, "pipe_layout", None)
    if layout is None:
        return []
    mine = dict(model.named_parameters())
    return [(mine.get(n), layout.state[n][0]) for n in layout.shared()]


def _tail_parameters(model: nn.Module) -> list:
    """The parameters the loss tail uses: after_norm, CTC, decoders."""
    mods = (model.encoder.encoders.after_norm, model.ctc, model.decoder)
    return [p for m in mods for p in m.parameters() if p.requires_grad]


def make_pp_loss_fn(model: nn.Module, mesh: Mesh, num_micro: int,
                    tail_on_last_stage: bool = False):
    """loss_fn(model, batch) -> metrics for build_train_step: the encoder
    block stack as a GPipe pipeline of `num_micro` microbatches over the
    mesh's pipe group (make_pipe_mesh; apply_mesh(model, mesh) first).
    The rank's rows must divide into num_micro: JAX's B % M == 0 with
    each microbatch divisible over 'data'."""
    if getattr(model, "moe_experts", 0):
        raise ValueError("pipeline parallelism with mixture-of-experts "
                         "layers is not supported (as in JAX)")
    enc = model.encoder
    if enc.static_chunk_size > 0 or enc.use_dynamic_chunk:
        raise ValueError("the pipeline path supports full-context "
                         "attention only (no chunk masks), as in JAX")
    if mesh.tp > 1:
        raise ValueError("the pipeline path runs on a ('data', 'pipe') "
                         "mesh, without tensor sharding")
    if mesh.pp > 1 and not hasattr(model, "pipe_layout"):
        raise ValueError("apply_mesh(model, mesh) keeps this rank's stage "
                         "first")
    names = sorted(["acc", "loss", "loss_ctc"]
                   + (["loss_att"] if model.ctc_weight < 1.0 else []))

    def loss_fn(model: nn.Module, batch: dict) -> dict:
        b = batch["features"].shape[0]
        if b % num_micro:
            raise ValueError(f"{b} rows of this data rank do not divide "
                             f"into {num_micro} microbatches")
        streams = _Streams(model.generator)
        set_generator(model.encoder.embed, streams(HEAD))
        xs, pos_emb, out_lens = model.pipeline_head(
            batch["features"], batch["features_length"])
        mask_pad = make_non_pad_mask(out_lens, xs.shape[1])[:, None, :]
        sched = _Schedule(_stage_layers(model, mesh), mesh, num_micro,
                          mask_pad, pos_emb, streams,
                          _shared_parameters(model))
        tail_gen = streams(TAIL)
        set_generator(model.ctc, tail_gen)
        set_generator(model.decoder, tail_gen)

        def tail(x):
            return model.pipeline_tail(x, out_lens, batch["targets"],
                                       batch["targets_length"])

        if not tail_on_last_stage:
            return tail(_Pipeline.apply(xs, sched))

        def tail_vector(x):
            m = tail(x)
            return torch.stack([m[k].float() for k in names])

        vec = _PipelineTail.apply(xs, sched, tail_vector,
                                  _tail_parameters(model), len(names))
        return dict(zip(names, vec.unbind()))

    return loss_fn
