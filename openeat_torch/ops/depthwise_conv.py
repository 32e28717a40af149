"""Depthwise 1-D convolution: the hand-written CUDA kernel K3, its
backward, and their plain PyTorch versions.

Port of openeat_tpu/ops/depthwise_conv.py. The TPU kernel it replaces is
``_kernel`` there (launched by ``_pallas_dwconv``): a VALID depthwise
conv of a caller-padded x [B, T+K-1, C] with taps w [K, C], accumulated
in float32 over the K taps in order, output in x's dtype, no bias. Its
backward ``_bwd`` reruns that kernel for dgrad (dy padded by K-1 on both
sides, taps reversed) and leaves wgrad, dw[j, c] = sum_{b,t} x[b, t+j, c]
* dy[b, t, c], to XLA; here wgrad is a CUDA kernel too, because a
reduction is not a matrix product.

All three are bound by device-memory bytes. The forward and the dgrad
are one kernel body with two entries (openeat_torch/csrc/
depthwise_conv.cu): each block loads zero-filled input windows into a
ring in shared memory asynchronously (TMA, or cp.async where the rows
are not 16-byte multiples), keeps its taps in registers, and moves four
channels per thread per access (16 bytes of float32, 8 of bfloat16).
The dgrad reads dy and the forward's w as they are: its K-1 halo is the
loads' zero fill and its reversed taps a read order, so it is one
launch. :func:`launch_plan` is the launch
decision in Python (the route it passes, the tiles the kernel's launcher
derives), so the CPU tests reach it. wgrad writes per-block
partial sums and adds them in a second pass in a fixed order (no float
atomics), so two runs give the same bits.

:func:`depthwise_conv1d` is a ``torch.autograd.Function`` on both
devices: a CUDA tensor runs the kernels forward and backward, a CPU
tensor runs the plain versions of the same formulas, so the CPU tests
exercise the backward that the card runs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from openeat_torch.ops import nvcc

SOURCE = "depthwise_conv.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def depthwise_conv1d_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Shift-and-add reference: x [B, T+K-1, C], w [K, C] -> [B, T, C] in
    x.dtype, float32 accumulation over taps j = 0..K-1."""
    k = w.shape[0]
    t = x.shape[1] - k + 1
    wf = w.float()
    acc = x[:, 0:t].float() * wf[0]
    for j in range(1, k):
        acc = acc + x[:, j:j + t].float() * wf[j]
    return acc.to(x.dtype)


def _pad_dy(dy: torch.Tensor, k: int) -> torch.Tensor:
    return F.pad(dy, (0, 0, k - 1, k - 1)).contiguous()


def depthwise_conv1d_dgrad_plain(dy: torch.Tensor,
                                 w: torch.Tensor) -> torch.Tensor:
    """dx [B, T+K-1, C] in dy's dtype: the forward on dy padded by K-1 on
    both sides with the taps reversed, w cast to dy's dtype."""
    return depthwise_conv1d_plain(_pad_dy(dy, w.shape[0]),
                                  w.flip(0).to(dy.dtype))


def depthwise_conv1d_wgrad_plain(x: torch.Tensor,
                                 dy: torch.Tensor) -> torch.Tensor:
    """dw [K, C] in x's dtype, summed in float32:
    dw[j, c] = sum_{b,t} x[b, t+j, c] * dy[b, t, c]."""
    t = dy.shape[1]
    k = x.shape[1] - t + 1
    dyf = dy.float()
    return torch.stack([(x[:, j:j + t].float() * dyf).sum(dim=(0, 1))
                        for j in range(k)]).to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor, name: str) -> None:
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"{name} wants [B, T, C] and w [K, C]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 tensors and w of "
                        f"the same dtype; got {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"{name}: input on {x.device} but w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name} needs contiguous tensors")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


# The kernel's fixed tiling (openeat_torch/csrc/depthwise_conv.cu): VEC
# channels and RT output rows per thread, at most C_TILE channels and
# T_TILE output rows per item, a ring of STAGES input windows per block,
# BLOCKS_PER_SM blocks per SM, the taps in registers for K_FIXED.
VEC = 4
RT = 4
C_TILE = 64
T_TILE = 32
STAGES = 2
BLOCKS_PER_SM = 2
K_FIXED = 15
K_MAX = 64
H100_SMS = 132
SMEM_MAX = 232448
MAX_BOX = 256


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call of the K3 kernel is cut. A block owns a ``c_tile``
    channel slice (``grid[0]`` of them) and walks items (batch row, time
    tile of T_TILE output rows) ``grid[1]`` apart. Each item reads input
    rows [t0 - pad_left, t0 - pad_left + rows) of [B, t_in, C], zero
    outside [0, t_in), through the TMA box ``tma_box`` (channels, rows,
    batch) or, where ``route`` is ``"cp.async"``, copies of
    ``copy_bytes``."""

    dgrad: bool           # the dgrad entry, else the forward's
    route: str            # "tma" or "cp.async"
    copy_bytes: int       # 0 on the TMA route, else 4, 8 or 16
    c_tile: int
    rows: int             # input window per item: T_TILE + K - 1
    pad_left: int
    t_out: int
    t_tiles: int
    n_items: int
    grid: tuple[int, int]
    block: tuple[int, int]  # (channel vectors, row groups of RT)
    smem_bytes: int
    tma_box: tuple[int, int, int] | None
    taps_in_registers: bool


@functools.lru_cache(maxsize=1024)
def launch_plan(batch: int, t_in: int, c: int, k: int, itemsize: int, *,
                dgrad: bool, x_ptr: int = 0,
                num_sms: int = H100_SMS) -> LaunchPlan:
    """The launch of openeat_dwconv1d_fwd (``dgrad=False``: input
    [batch, t_in, C] is the caller-padded x, t_out = t_in - K + 1) or
    openeat_dwconv1d_dgrad (input is dy, t_out = t_in + K - 1, the K - 1
    halo read as zeros). ``x_ptr`` is the input's address (mod 16 is
    enough), whose alignment picks the route with the row's bytes: TMA
    where both are multiples of 16, else cp.async copies of the largest
    of 16, 8, 4 bytes that divides both. The route is what the kernel is
    told; the rest is what its launcher derives from the same constants.
    Raises ValueError for what no route takes."""
    if itemsize not in (2, 4):
        raise ValueError(f"K3 kernel takes 2- or 4-byte elements, not "
                         f"{itemsize}")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"K3 kernel takes 1 <= K <= {K_MAX}; got K={k}")
    pad_left = k - 1 if dgrad else 0
    t_out = t_in + k - 1 if dgrad else t_in - k + 1
    if batch < 1 or c < 1 or t_in < 1 or t_out < 1:
        raise ValueError(f"empty K3 problem: B={batch}, T_in={t_in}, C={c}, "
                         f"K={k}")
    c_bytes = c * itemsize
    if c_bytes % 16 == 0 and x_ptr % 16 == 0:
        route, copy_bytes = "tma", 0
    else:
        sizes = [g for g in (16, 8, 4) if c_bytes % g == 0
                 and x_ptr % g == 0]
        if not sizes:
            raise ValueError(
                f"K3 kernel needs rows of channels and the input's address "
                f"to be multiples of 4 bytes; got C={c} x {itemsize} bytes "
                f"at address offset {x_ptr % 16} mod 16")
        route, copy_bytes = "cp.async", sizes[0]
    # a channel tile of whole vectors and whole 16-byte rows (TMA boxes,
    # 16-byte copies), no wider than C needs
    step = max(VEC, 16 // itemsize)
    c_tile = min(C_TILE, -(-c // step) * step)
    taps_in_registers = k == K_FIXED
    rows = T_TILE + k - 1
    t_tiles = -(-t_out // T_TILE)
    n_items = batch * t_tiles
    if n_items >= 2 ** 31:
        raise ValueError(f"K3 kernel takes fewer than 2**31 items; got "
                         f"B={batch} x {t_tiles} time tiles")
    n_ctiles = -(-c // c_tile)
    grid_y = min(n_items, -(-BLOCKS_PER_SM * num_sms // n_ctiles), 65535)
    stage_bytes = -(-rows * c_tile * itemsize // 128) * 128
    smem = 128 + STAGES * stage_bytes \
        + (0 if taps_in_registers else k * c_tile * 4) + STAGES * 8
    return LaunchPlan(
        dgrad=dgrad, route=route, copy_bytes=copy_bytes, c_tile=c_tile,
        rows=rows, pad_left=pad_left, t_out=t_out, t_tiles=t_tiles,
        n_items=n_items, grid=(n_ctiles, grid_y),
        block=(c_tile // VEC, T_TILE // RT), smem_bytes=smem,
        tma_box=(c_tile, rows, 1) if route == "tma" else None,
        taps_in_registers=taps_in_registers)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _entry(name: str, argtypes: tuple, restype=ctypes.c_int):
    """The library's C function `name`, bound once per process."""
    fn = getattr(nvcc.load_library(SOURCE), name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def device_plan(src: torch.Tensor, k: int, dgrad: bool) -> LaunchPlan:
    """:func:`launch_plan` for the input tensor `src` on its card."""
    b, t_in, c = src.shape
    return launch_plan(b, t_in, c, k, src.element_size(), dgrad=dgrad,
                       x_ptr=src.data_ptr() % 16,
                       num_sms=_num_sms(src.device.index))


_CONV_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 6 \
    + (ctypes.c_void_p,)


def launch(src: torch.Tensor, w: torch.Tensor,
           plan: LaunchPlan) -> torch.Tensor:
    """One launch of the K3 kernel's forward or dgrad entry on the card
    by `plan`'s route (from :func:`device_plan` for these tensors): src
    [B, T_in, C] and w [K, C] -> [B, plan.t_out, C]. Counts nothing: the
    wrappers do."""
    b, t_in, c = src.shape
    name = "openeat_dwconv1d_dgrad" if plan.dgrad else "openeat_dwconv1d_fwd"
    out = torch.empty((b, plan.t_out, c), dtype=src.dtype,
                      device=src.device)
    with torch.cuda.device(src.device):
        rc = _entry(name, _CONV_ARGS)(
            src.data_ptr(), w.data_ptr(), out.data_ptr(), b, t_in, c,
            w.shape[0], _DTYPE_CODE[src.dtype], plan.copy_bytes,
            _stream(src))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with code {rc} ({plan})")
    return out


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return depthwise_conv1d_plain(x, w)
    plan = device_plan(x, w.shape[0], dgrad=False)
    depthwise_conv1d.launches += 1
    return launch(x, w, plan)


def depthwise_conv1d_dgrad(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx [B, T+K-1, C] in dy's dtype from dy [B, T, C] and the forward's
    w [K, C] (cast to dy's dtype where they differ). A CUDA tensor runs
    the K3 kernel's dgrad entry once, on dy and w as they are: the K-1
    halo is the loads' zero fill and the reversed taps a read order (each
    launch adds one to ``depthwise_conv1d_dgrad.launches``); a CPU tensor
    takes :func:`depthwise_conv1d_dgrad_plain`."""
    w = w.to(dy.dtype)
    _check(dy, w, "depthwise_conv1d_dgrad")
    if dy.device.type == "cpu":
        return depthwise_conv1d_dgrad_plain(dy, w)
    plan = device_plan(dy, w.shape[0], dgrad=True)
    depthwise_conv1d_dgrad.launches += 1
    return launch(dy, w, plan)


def depthwise_conv1d_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dw [K, C] in x's dtype from x [B, T+K-1, C] and dy [B, T, C] of the
    same dtype. A CUDA tensor runs the wgrad kernel (each launch adds one
    to ``depthwise_conv1d_wgrad.launches``); a CPU tensor takes
    :func:`depthwise_conv1d_wgrad_plain`."""
    b, tp, c = x.shape
    if dy.dim() != 3 or dy.shape[0] != b or dy.shape[2] != c \
            or dy.shape[1] > tp:
        raise ValueError(f"wgrad wants x [B, T+K-1, C] and dy [B, T, C]; "
                         f"got {tuple(x.shape)}, {tuple(dy.shape)}")
    if dy.dtype != x.dtype or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"wgrad takes float32 or bfloat16 x and dy of one "
                        f"dtype; got {x.dtype}, {dy.dtype}")
    x, dy = x.contiguous(), dy.contiguous()
    if x.device.type == "cpu":
        return depthwise_conv1d_wgrad_plain(x, dy)
    k = tp - dy.shape[1] + 1
    scratch = _entry("openeat_dwconv1d_wgrad_scratch", (ctypes.c_int,) * 4,
                     ctypes.c_longlong)
    fn = _entry("openeat_dwconv1d_wgrad", (ctypes.c_void_p,) * 4
                + (ctypes.c_int,) * 5 + (ctypes.c_void_p,))
    partial = torch.empty((scratch(b, tp, c, k),), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((k, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        depthwise_conv1d_wgrad.launches += 1
        rc = fn(x.data_ptr(), dy.data_ptr(), partial.data_ptr(),
                dw.data_ptr(), b, tp, c, k, _DTYPE_CODE[x.dtype], _stream(x))
    if rc != 0:
        raise RuntimeError(f"depthwise_conv1d wgrad launch failed: "
                           f"cudaError {rc}")
    return dw


class _DepthwiseConv1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = depthwise_conv1d_dgrad(dy, w).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = depthwise_conv1d_wgrad(x, dy.to(x.dtype)).to(w.dtype)
        return dx, dw


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID depthwise conv. x: [B, T+K-1, C] (padded by the caller for
    causal or symmetric semantics); w: [K, C]. Returns [B, T, C] in
    x.dtype, differentiable in x and w.

    A CUDA tensor goes to the CUDA kernels (built on first use); a CPU
    tensor goes to the plain versions. Every forward kernel launch adds
    one to ``depthwise_conv1d.launches``."""
    _check(x, w, "depthwise_conv1d")
    if x.shape[1] < w.shape[0]:
        raise ValueError(f"input length {x.shape[1]} < kernel {w.shape[0]}")
    return _DepthwiseConv1d.apply(x, w)


depthwise_conv1d.launches = 0
depthwise_conv1d_dgrad.launches = 0
depthwise_conv1d_wgrad.launches = 0
