"""The bfloat16 weight mirror of the training step, and the fused update
that writes it.

The model keeps flax's rule: float32 parameters, cast to the compute
dtype at use. The parameters change only in the update, so a cast taken
once after the update gives the bits of every cast until the next one.
A :class:`WeightMirror` holds that cast: every parameter the step
differentiates has a bfloat16 copy in one flat buffer (ops/
multi_tensor.py:ParamTable), and a leaf tensor that requires grad views
each copy. While a training step's forward runs (:func:`reading`),
:func:`at_compute`, which the modules call where they cast a parameter,
hands out the leaf instead of casting; outside it (eval, decode, the
quantized Dense, another thread) the modules cast as before.

The backward leaves each leaf its bfloat16 gradient, the bits that the
cast's backward (ToCopyBackward) widened to float32 before, and leaves a
parameter read without a cast (LayerNorm's, the embedding's) its float32
one. After each micro-batch one multi-tensor launch (:meth:`gather`)
adds both into the float32 accumulator, in AccumulateGrad's float32
order, divides by accum_grad after the last micro-batch, and clears the
leaves' and parameters' gradients, so that autograd never adds in
bfloat16 or launches an add a parameter. Then each parameter's ``.grad``
is its slice of the accumulator, as after the step's own backward.

The update (:meth:`update`) is the train step's rule in three device
operations: one launch of the global norm over the accumulator (the
clip scale beside it), the host's read of the norm (the step's one
sync), and, where it is finite, one launch of the clip and Adam (or
AdamW) over every trainable parameter, which writes the float32
parameter, ``exp_avg`` and ``exp_avg_sq`` in ``optimizer.state[p]``
and the mirror. A non-finite norm leaves parameters, moments, mirror and
step counts as they are. The optimizer's step counts are views of one
CPU tensor, added to at once.

A mirror exists for a model whose modules compute in bfloat16 over
float32 parameters, trained without a mesh by a torch.optim.Adam or
AdamW of one parameter group without amsgrad, maximize, capturable,
differentiable or fused; elsewhere the train step takes its own path
(float32 models, SGD, meshes). The train step keeps it on its
TrainState: :func:`for_step`, at the start of each step, builds it, or
rewrites it where a parameter was written since the mirror was (its
``_version`` moved: a checkpoint load, the benchmark's set-up,
averaging, an update the step's own path took; on the CPU the plain
update's own in-place writes too), or builds it anew where
it no longer fits (a parameter rebound to other memory, a new optimizer
state from ``load_state_dict``). A write through ``p.data``, which bumps
no version, is not seen.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
from torch import nn

from openeat_torch.ops import multi_tensor as mt
from openeat_torch.utils.profiling import span

MIRROR_DTYPE = torch.bfloat16

# `views`: the leaves this thread's training forward reads, while it runs
_local = threading.local()


def at_compute(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The parameter `p` in the compute dtype `dtype`: the mirror's leaf
    inside a training step's forward, else p cast (p itself where it
    already has that dtype)."""
    views = getattr(_local, "views", None)
    if views is not None:
        v = views.get(p)
        if v is not None and v.dtype == dtype:
            return v
    return p if p.dtype == dtype else p.to(dtype)


@contextlib.contextmanager
def reading(mirror: "WeightMirror | None"):
    """The context of a forward, on this thread, that reads `mirror`'s
    leaves (none for None)."""
    _local.views = None if mirror is None else mirror.leaves
    try:
        yield
    finally:
        _local.views = None


def _compute_dtype(model: nn.Module) -> torch.dtype | None:
    """The one compute dtype other than float32 among the model's
    modules, or None."""
    dts = {m.compute_dtype for m in model.modules()
           if isinstance(getattr(m, "compute_dtype", None), torch.dtype)}
    dts.discard(torch.float32)
    return dts.pop() if len(dts) == 1 else None


def _fused_adam(optimizer) -> bool:
    """Whether the fused update does what `optimizer`'s step does."""
    if not isinstance(optimizer, torch.optim.Adam) \
            or len(optimizer.param_groups) != 1:
        return False
    g = optimizer.param_groups[0]
    if any(g.get(k) for k in ("amsgrad", "maximize", "capturable",
                              "differentiable", "fused")):
        return False
    return not any(isinstance(x, torch.Tensor)
                   for x in (g["lr"], *g["betas"], g["eps"],
                             g["weight_decay"]))


class WeightMirror:
    """The mirror of `params` (the model's parameters that require grad,
    in the model's order) and the update of those of them that
    `optimizer` holds; the optimizer's state is made where it has none.
    :func:`for_step` makes it."""

    def __init__(self, params: list, optimizer: torch.optim.Adam):
        self.params = params
        self.optimizer = optimizer
        group = optimizer.param_groups[0]
        self.decoupled = bool(group.get(
            "decoupled_weight_decay",
            isinstance(optimizer, torch.optim.AdamW)))
        held = {id(p) for p in group["params"]}
        live = [p for p in params if id(p) in held]
        state = optimizer.state
        if len({bool(state.get(p)) for p in live}) > 1:
            raise ValueError("some parameters have Adam state, some not")
        if not state.get(live[0]):
            for p in live:
                state[p] = {"step": torch.tensor(0.0),
                            "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": torch.zeros_like(p)}
        steps = {float(state[p]["step"]) for p in live}
        if len(steps) > 1:
            raise ValueError("parameters at different Adam steps")
        # one CPU tensor of the step counts; each state's "step" a view
        self.steps = torch.full((len(live),), steps.pop(), dtype=torch.float32)
        for i, p in enumerate(live):
            state[p]["step"] = self.steps[i]
        self.table = mt.ParamTable(
            params, [(state[p]["exp_avg"], state[p]["exp_avg_sq"])
                     if id(p) in held else None for p in params])
        self.sentinel = (live[0], state[live[0]]["exp_avg"])
        self.leaves = {p: v.detach().requires_grad_(True)
                       for p, v in zip(params, self.table.copies)}
        # the accumulator holds a step's gradients no update took yet
        self.pending = False
        self.write()

    def fits(self, optimizer) -> bool:
        """Whether the mirror's update is still `optimizer`'s, over the
        parameters' memory."""
        p, exp_avg = self.sentinel
        return optimizer is self.optimizer and _fused_adam(optimizer) \
            and optimizer.state.get(p, {}).get("exp_avg") is exp_avg \
            and self.table.pointers() == self.ptrs

    def write(self) -> None:
        """The mirror from the parameters, and their versions."""
        mt.write_mirror(self.table)
        self.ptrs = self.table.pointers()
        self.versions = [p._version for p in self.params]

    def refresh(self) -> None:
        """Rewrite the mirror where a parameter was written since it was."""
        if [p._version for p in self.params] != self.versions:
            self.write()

    # ---- a step

    def begin(self) -> None:
        """Clear the leaves' gradients a failed step may have left."""
        self.pending = False
        for v in self.leaves.values():
            if v.grad is not None:
                v.grad = None

    def gather(self, first: bool, accum: int) -> None:
        """Add the micro-batch's gradients into the accumulator (the
        first micro-batch's as they are) and clear them; `accum` divides
        after the last micro-batch (1 before it)."""
        leaves = self.leaves.values()
        g16 = [v.grad for v in leaves]
        g32 = [p.grad for p in self.params]
        mt.gather(self.table, g16, g32, first, accum)
        for v in leaves:
            v.grad = None
        for p, g in zip(self.params, g32):
            if g is not None:
                p.grad = None

    def hand_over(self) -> None:
        """Each parameter's .grad is its slice of the accumulator, which
        the next update takes."""
        for p, g in zip(self.params, self.table.grads):
            p.grad = g
        self.pending = True

    def update(self, lr: float, grad_clip: float) -> tuple[torch.Tensor,
                                                           bool]:
        """The clip and Adam step at learning rate `lr` on the gradients
        handed over, or the skip of a non-finite norm: (norm, applied)."""
        self.pending = False
        out = mt.global_norm(self.table, grad_clip)
        gnorm = out[0]
        with span("openeat.step.sync"):
            finite = math.isfinite(float(gnorm))
        if finite:
            g = self.optimizer.param_groups[0]
            self.steps.add_(1)
            h = mt.AdamHyper.of(lr, g["betas"], g["eps"], g["weight_decay"],
                                self.decoupled, float(self.steps[0]))
            with span("openeat.step.mirror"):
                mt.adam(self.table, out[1], h)
        return gnorm, finite


def _build(model: nn.Module, optimizer) -> WeightMirror | None:
    if not _fused_adam(optimizer) or _compute_dtype(model) != MIRROR_DTYPE:
        return None
    params = [p for p in model.parameters() if p.requires_grad]
    if not params or any(p.dtype != torch.float32 or not p.is_contiguous()
                         for p in params) \
            or len({p.device for p in params}) != 1:
        return None
    ids = {id(p) for p in params}
    if any(id(p) not in ids for p in optimizer.param_groups[0]["params"]):
        return None
    try:
        return WeightMirror(params, optimizer)
    except ValueError:
        return None


def for_step(state, mesh=None) -> WeightMirror | None:
    """The mirror a train step of `state` (a TrainState) reads and
    updates, kept in ``state.mirror``: the one it has, rewritten where a
    parameter was written since, if it still fits the optimizer; else a
    new one; None on a mesh or where no mirror fits."""
    mirror = state.mirror
    if mirror is not None and (mesh is not None
                               or not mirror.fits(state.optimizer)):
        mirror = None
    if mirror is not None:
        mirror.refresh()
    elif mesh is None:
        mirror = _build(state.model, state.optimizer)
    state.mirror = mirror
    return mirror
