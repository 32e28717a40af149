"""Multi-tensor kernels of the training update: the gradient gather, the
global norm, and clip + Adam with the bfloat16 weight mirror, each one
launch over every parameter, and their plain PyTorch versions.

They replace no TPU kernel: the JAX package's update is one jitted XLA
program (optax's global norm, clip and adam), which XLA fuses. Eager
PyTorch spends a few launches a parameter on it, and at the benchmark's
620 parameters those launches bound the update, not its bytes. The CUDA
kernels (openeat_torch/csrc/multi_tensor.cu) are bound by device-memory
bytes: the gather 6-12 bytes a parameter, the norm 4, Adam 30.

A :class:`ParamTable` lays the parameters end to end in a float32
gradient accumulator and a bfloat16 mirror, each parameter's slice at a
multiple of ALIGN elements, with a view of each slice shaped like the
parameter (``grads``, ``copies``). On a card it also holds the kernels'
table (each parameter's address, its Adam moments' addresses, offset and
size) and their block map (one block a CHUNK of one parameter), built
once. The wrappers take a table: a CPU table runs the plain versions,
which are the arithmetic of the train step's own PyTorch path
(AccumulateGrad's float32 sums, ``div_``, the global norm, the clip,
torch.optim.Adam's single-tensor step) and so give its bits; a CUDA
table launches the kernel, one more in the wrapper's ``launches``. On
the card the kernels differ from the plain versions in the norm's
summation (double, in NORM_BLOCKS fixed slices, against float32 a
tensor) and in the fused multiply-adds of Adam's arithmetic.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from openeat_torch.ops import nvcc

SOURCE = "multi_tensor.cu"
# the kernels' constants (openeat_torch/csrc/multi_tensor.cu)
THREADS = 256
CHUNK = 8192
GATHER_MAX = 1000
NORM_BLOCKS = 264
ENTRY_BYTES = 40
ALIGN = 8   # elements: 32-byte float32 and 16-byte bfloat16 slices


@dataclass(frozen=True)
class AdamHyper:
    """One update's scalars, as torch.optim.Adam's single-tensor step
    computes them (Python floats; the kernel takes them in float32)."""

    beta1_weight: float       # 1 - beta1
    beta2: float
    one_minus_beta2: float
    step_size: float          # -lr / (1 - beta1 ** t)
    bc2_sqrt: float           # (1 - beta2 ** t) ** 0.5
    eps: float
    weight_decay: float
    decay: float              # 1 - lr * weight_decay (AdamW)
    decoupled: bool

    @classmethod
    def of(cls, lr: float, betas: tuple[float, float], eps: float,
           weight_decay: float, decoupled: bool, step: float) -> "AdamHyper":
        beta1, beta2 = betas
        return cls(beta1_weight=1 - beta1, beta2=beta2,
                   one_minus_beta2=1 - beta2,
                   step_size=-(lr / (1 - beta1 ** step)),
                   bc2_sqrt=(1 - beta2 ** step) ** 0.5, eps=eps,
                   weight_decay=weight_decay, decay=1 - lr * weight_decay,
                   decoupled=bool(decoupled))


class ParamTable:
    """`params` (float32, contiguous, on one device) laid end to end, with
    `moments[i]` = (exp_avg, exp_avg_sq) of params[i] or None where the
    update leaves it as it is."""

    def __init__(self, params: list, moments: list):
        if len(params) != len(moments) or not params:
            raise ValueError("a table needs one moments entry a parameter")
        self.device = params[0].device
        for p, mo in zip(params, moments):
            for t in (p,) + (tuple(mo) if mo is not None else ()):
                if t.dtype != torch.float32 or not t.is_contiguous() \
                        or t.device != self.device or t.shape != p.shape:
                    raise ValueError("a table takes contiguous float32 "
                                     "tensors of their parameter's shape, "
                                     "on one device")
        self.params, self.moments = list(params), list(moments)
        self.numels = [p.numel() for p in params]
        self.offsets, total = [], 0
        for n in self.numels:
            self.offsets.append(total)
            total += -(-n // ALIGN) * ALIGN
        self.total = total
        self.acc = torch.zeros(total, dtype=torch.float32, device=self.device)
        self.mirror = torch.zeros(total, dtype=torch.bfloat16,
                                  device=self.device)
        self.grads = self._views(self.acc)
        self.copies = self._views(self.mirror)
        # the kernels' blocks: entry i's chunks are blocks
        # [first_block[i], first_block[i + 1])
        self.first_block = [0]
        for n in self.numels:
            self.first_block.append(self.first_block[-1] + -(-n // CHUNK))
        self.n_blocks = self.first_block[-1]
        if self.device.type == "cuda":
            rows = [[p.data_ptr(), mo[0].data_ptr() if mo else 0,
                     mo[1].data_ptr() if mo else 0, off, n]
                    for p, mo, off, n in zip(params, moments, self.offsets,
                                             self.numels)]
            self.entries = torch.tensor(rows, dtype=torch.int64).to(
                self.device)
            blocks = [[i, c] for i, n in enumerate(self.numels)
                      for c in range(-(-n // CHUNK))]
            self.blocks = torch.tensor(blocks, dtype=torch.int32).to(
                self.device)
            self.partial = torch.zeros(NORM_BLOCKS, dtype=torch.float64,
                                       device=self.device)
            self.ticket = torch.zeros(1, dtype=torch.int32,
                                      device=self.device)

    def _views(self, flat: torch.Tensor) -> list:
        return [flat[o:o + n].view(p.shape) for p, o, n
                in zip(self.params, self.offsets, self.numels)]

    def pointers(self) -> list[int]:
        """The parameters' addresses the table was built on."""
        return [p.data_ptr() for p in self.params]


# ---- plain versions

def gather_plain(table: ParamTable, g16: list, g32: list, first: bool,
                 accum: int) -> None:
    """Into each grads[i]: the micro-batch's gradient f32(g16[i]) +
    g32[i] (either may be None), added to what it holds unless `first`,
    then divided by `accum` (the last micro-batch's divide, 1 else)."""
    with torch.no_grad():
        for acc, a, f in zip(table.grads, g16, g32):
            t = a.float() if a is not None else None
            if f is not None:
                t = f if t is None else t + f
            if first:
                if t is None:
                    acc.zero_()
                else:
                    acc.copy_(t)
            elif t is not None:
                acc.add_(t)
            if accum != 1:
                acc.div_(accum)


def global_norm_plain(table: ParamTable, grad_clip: float) -> torch.Tensor:
    """[norm, clip scale]: the flat global norm of the gradients, float32
    a tensor, and min(1, grad_clip / max(norm, 1e-12))."""
    gnorm = torch.stack([g.float().square().sum()
                         for g in table.grads]).sum().sqrt()
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    return torch.stack([gnorm, scale])


def adam_plain(table: ParamTable, scale: torch.Tensor, h: AdamHyper) -> None:
    """torch.optim.Adam's (AdamW's) single-tensor step on grads[i] *
    scale for every entry with moments, then copies[i] = bf16(param)."""
    with torch.no_grad():
        for p, mo, g, c in zip(table.params, table.moments, table.grads,
                               table.copies):
            if mo is None:
                continue
            exp_avg, exp_avg_sq = mo
            g = g * scale
            if h.weight_decay != 0:
                if h.decoupled:
                    p.mul_(h.decay)
                else:
                    g = g.add(p, alpha=h.weight_decay)
            exp_avg.lerp_(g, h.beta1_weight)
            exp_avg_sq.mul_(h.beta2).addcmul_(g, g, value=h.one_minus_beta2)
            denom = (exp_avg_sq.sqrt() / h.bc2_sqrt).add_(h.eps)
            p.addcdiv_(exp_avg, denom, value=h.step_size)
            c.copy_(p)


def write_mirror_plain(table: ParamTable) -> None:
    """copies[i] = bf16(params[i]) for every entry."""
    with torch.no_grad():
        for p, c in zip(table.params, table.copies):
            c.copy_(p)


# ---- the kernels

@functools.cache
def _entry(name: str, argtypes: tuple):
    """The library's C function `name`, bound once per process; the first
    binding checks the library's constants against this module's."""
    lib = nvcc.load_library(SOURCE)
    if name != "openeat_mt_constants":
        got = (ctypes.c_int * 5)()
        _entry("openeat_mt_constants", (ctypes.c_void_p,))(got)
        want = (THREADS, CHUNK, GATHER_MAX, NORM_BLOCKS, ENTRY_BYTES)
        if tuple(got) != want:
            raise RuntimeError(f"{SOURCE} has constants {tuple(got)}, the "
                               f"wrapper {want}")
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with code {rc}")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_GATHER_ARGS = (_P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _F, _P)
_NORM_ARGS = (_P, ctypes.c_longlong, _P, _P, _F, _P, _P)
_ADAM_ARGS = (_P, _P, _I, _P, _P, _P, _I) + (_F,) * 8 + (_I, _P)


def _address(g, dtype: torch.dtype, numel: int) -> int:
    if g is None:
        return 0
    if g.dtype != dtype or not g.is_contiguous() or g.numel() != numel:
        raise ValueError(f"gather takes contiguous {dtype} gradients of "
                         f"their parameter's size; got {g.dtype}, "
                         f"{tuple(g.shape)}")
    return g.data_ptr()


def gather(table: ParamTable, g16: list, g32: list, first: bool,
           accum: int = 1) -> None:
    """:func:`gather_plain`: one launch of openeat_mt_gather a
    GATHER_MAX entries on a card (``gather.launches``)."""
    if table.device.type == "cpu":
        gather_plain(table, g16, g32, first, accum)
        return
    fn = _entry("openeat_mt_gather", _GATHER_ARGS)
    inv = 1.0 / accum   # a multiply by 1/accum, as div_ by a number runs
    stream = _stream(table.acc)
    n = len(table.params)
    for e0 in range(0, n, GATHER_MAX):
        e1 = min(n, e0 + GATHER_MAX)
        a16 = (ctypes.c_longlong * (e1 - e0))(*[
            _address(g16[i], torch.bfloat16, table.numels[i])
            for i in range(e0, e1)])
        a32 = (ctypes.c_longlong * (e1 - e0))(*[
            _address(g32[i], torch.float32, table.numels[i])
            for i in range(e0, e1)])
        b0 = table.first_block[e0]
        with nvcc.launch_region("openeat_mt_gather"):
            rc = fn(table.entries.data_ptr(), table.blocks.data_ptr(), b0,
                    table.first_block[e1] - b0, e0, e1 - e0, a16, a32,
                    table.acc.data_ptr(), int(first), inv, stream)
        _raise("openeat_mt_gather", rc)
        gather.launches += 1


gather.launches = 0


def global_norm(table: ParamTable, grad_clip: float) -> torch.Tensor:
    """:func:`global_norm_plain` into a new [2] float32 tensor: one launch
    of openeat_mt_norm on a card (``global_norm.launches``)."""
    if table.device.type == "cpu":
        return global_norm_plain(table, grad_clip)
    out = torch.empty(2, dtype=torch.float32, device=table.device)
    fn = _entry("openeat_mt_norm", _NORM_ARGS)
    with nvcc.launch_region("openeat_mt_norm"):
        rc = fn(table.acc.data_ptr(), table.total, table.partial.data_ptr(),
                table.ticket.data_ptr(), float(grad_clip), out.data_ptr(),
                _stream(out))
    _raise("openeat_mt_norm", rc)
    global_norm.launches += 1
    return out


global_norm.launches = 0


def _adam_launch(table: ParamTable, scale, h: AdamHyper | None) -> None:
    fn = _entry("openeat_mt_adam", _ADAM_ARGS)
    name = "openeat_mt_adam" if h is not None else "openeat_mt_mirror"
    args = ((h.beta1_weight, h.beta2, h.one_minus_beta2, h.step_size,
             h.bc2_sqrt, h.eps, h.weight_decay, h.decay, int(h.decoupled))
            if h is not None else (0.0,) * 8 + (0,))
    with nvcc.launch_region(name):
        rc = fn(table.entries.data_ptr(), table.blocks.data_ptr(),
                table.n_blocks, table.acc.data_ptr(),
                scale.data_ptr() if scale is not None else None,
                table.mirror.data_ptr(), int(h is None), *args,
                _stream(table.acc))
    _raise(name, rc)


def adam(table: ParamTable, scale: torch.Tensor, h: AdamHyper) -> None:
    """:func:`adam_plain`, `scale` a float32 on the table's device: one
    launch of openeat_mt_adam on a card (``adam.launches``)."""
    if table.device.type == "cpu":
        adam_plain(table, scale, h)
        return
    if scale.dtype != torch.float32 or scale.device != table.device:
        raise ValueError("adam takes the clip scale as a float32 on the "
                         "table's device")
    _adam_launch(table, scale, h)
    adam.launches += 1


adam.launches = 0


def write_mirror(table: ParamTable) -> None:
    """:func:`write_mirror_plain`: one launch of openeat_mt_adam's mirror
    pass on a card (``write_mirror.launches``)."""
    if table.device.type == "cpu":
        write_mirror_plain(table)
        return
    _adam_launch(table, None, None)
    write_mirror.launches += 1


write_mirror.launches = 0
