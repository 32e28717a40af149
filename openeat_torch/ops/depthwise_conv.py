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
are not 16-byte multiples; synchronous 2-byte element loads where no
4-byte copy fits), keeps its taps in registers (compile-time instances
for K = 15 and K = 31, the AIShell and LibriSpeech Conformers' kernels;
other K read them from shared memory), and moves four channels per
thread per access (16 bytes of float32, 8 of bfloat16). The dgrad
reads dy and the forward's w as they are: its K-1 halo is the loads'
zero fill and its reversed taps a read order, so it is one launch.
wgrad is one launch too: blocks stage long spans of x and dy by the
same routes and sum in registers; at K = 31 a channel tile's blocks are
one thread-block cluster that adds their partials through shared memory,
at other K the last block of each channel tile adds them from a
workspace (an integer ticket). Either adds them in a fixed order, with
no float atomics, so two runs give the same bits. :func:`launch_plan` and
:func:`wgrad_plan` are the launch decisions in Python (the route passed,
the tiles the kernel's launcher derives), so the CPU tests reach them.

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
# BLOCKS_PER_SM blocks per SM, the taps in registers for K_FIXED and
# K_WIDE (the wgrad reads K_FIXED alone).
VEC = 4
RT = 4
C_TILE = 64
T_TILE = 32
STAGES = 2
BLOCKS_PER_SM = 2
K_FIXED = 15
K_WIDE = 31
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
    batch) or, where ``route`` is ``"cp.async"`` or ``"element"``, copies
    of ``copy_bytes``."""

    dgrad: bool           # the dgrad entry, else the forward's
    route: str            # "tma", "cp.async" or "element"
    copy_bytes: int       # 0 on the TMA route, else 2, 4 or 8
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


def pick_route(row_bytes: int, itemsize: int, *ptrs: int) -> tuple[str, int]:
    """(route, copy_bytes) for rows of `row_bytes` at the addresses
    `ptrs` (mod 16 is enough): TMA (0) where the row and every address
    are multiples of 16 bytes, else cp.async copies of the larger of 8
    and 4 bytes that divides them all, else, for 2-byte elements,
    synchronous element loads ("element", 2). Raises ValueError where
    none fits (a float32 tensor off a 4-byte boundary)."""
    def fits(g):
        return row_bytes % g == 0 and all(p % g == 0 for p in ptrs)

    if fits(16):
        return "tma", 0
    for g in (8, 4):
        if fits(g):
            return "cp.async", g
    if itemsize == 2:
        return "element", 2
    raise ValueError(f"K3 kernel needs float32 rows and addresses on 4-byte "
                     f"boundaries; got rows of {row_bytes} bytes at address "
                     f"offsets {[p % 16 for p in ptrs]} mod 16")


def channel_tile(c: int, itemsize: int, cap: int = C_TILE) -> int:
    """A channel tile of whole vectors and whole 16-byte rows (TMA
    boxes), at most `cap` channels and no wider than C needs."""
    step = max(VEC, 16 // itemsize)
    return min(cap, -(-c // step) * step)


@functools.lru_cache(maxsize=1024)
def launch_plan(batch: int, t_in: int, c: int, k: int, itemsize: int, *,
                dgrad: bool, x_ptr: int = 0,
                num_sms: int = H100_SMS) -> LaunchPlan:
    """The launch of openeat_dwconv1d_fwd (``dgrad=False``: input
    [batch, t_in, C] is the caller-padded x, t_out = t_in - K + 1) or
    openeat_dwconv1d_dgrad (input is dy, t_out = t_in + K - 1, the K - 1
    halo read as zeros). ``x_ptr`` is the input's address (mod 16 is
    enough), whose alignment picks the route with the row's bytes
    (:func:`pick_route`). The route is what the kernel is told; the rest
    is what its launcher derives from the same constants. Raises
    ValueError for what no route takes."""
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
    route, copy_bytes = pick_route(c * itemsize, itemsize, x_ptr)
    c_tile = channel_tile(c, itemsize)
    taps_in_registers = k in (K_FIXED, K_WIDE)
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
    with torch.cuda.device(src.device), nvcc.launch_region(name):
        rc = _entry(name, _CONV_ARGS)(
            src.data_ptr(), w.data_ptr(), out.data_ptr(), b, t_in, c,
            w.shape[0], _DTYPE_CODE[src.dtype], plan.copy_bytes,
            _stream(src))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with code {rc} ({plan})")
    return out


def _count(wrapper, x_shape: tuple, k: int, dtype: torch.dtype) -> None:
    """One launch of `wrapper`'s kernel: one more in ``wrapper.launches``
    and in ``wrapper.shape_launches`` under the forward's input shape
    (B, T+K-1, C), K and the dtype's name."""
    wrapper.launches += 1
    key = (*x_shape, k, str(dtype).split(".")[-1])
    wrapper.shape_launches[key] = wrapper.shape_launches.get(key, 0) + 1


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return depthwise_conv1d_plain(x, w)
    plan = device_plan(x, w.shape[0], dgrad=False)
    _count(depthwise_conv1d, x.shape, w.shape[0], x.dtype)
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
    b, t, c = dy.shape
    _count(depthwise_conv1d_dgrad, (b, t + w.shape[0] - 1, c), w.shape[0],
           dy.dtype)
    return launch(dy, w, plan)


# The wgrad kernel's constants (openeat_torch/csrc/depthwise_conv.cu):
# at most W_C_TILE channels a block, items of at most W_ROWS output rows,
# W_GROUPS row groups a block, W_KC taps a pass for a K other than
# K_FIXED and K_WIDE, a ring of W_STAGES items, about W_BLOCKS_PER_SM
# blocks per SM, W_MAX_CTILES tickets at the workspace's head. K_WIDE
# has a tiling of its own: W_TAP_GROUPS groups of taps, at most
# W_WIDE_C_TILE channels and W_WIDE_ROWS output rows an item, W_WIDE_GROUPS
# row groups, and a cluster of at most W_CLUSTER blocks a channel tile.
W_C_TILE = 32
W_ROWS = 128
W_GROUPS = 16
W_KC = 8
W_TAP_GROUPS = 2
W_WIDE_C_TILE = 16
W_WIDE_GROUPS = 16
W_WIDE_ROWS = 226
W_CLUSTER = 8
W_STAGES = 3
W_BLOCKS_PER_SM = 1
W_MAX_CTILES = 1024


@dataclasses.dataclass(frozen=True)
class WgradPlan:
    """How one call of the wgrad kernel is cut. Each batch row's t_out
    output rows are ``q`` items of ``rows`` rows (the last one shorter);
    item i is (batch i // q, rows from (i % q) * rows). Block (ctile,
    split) owns channels [ctile * c_tile, + c_tile) and items [split *
    per, + per); row group g of its G = ``block[1]`` row groups takes
    rows [g * n // G, (g + 1) * n // G) of an item of n rows, in order.
    With ``one_pass`` (K_FIXED and K_WIDE, the kernel's compile-time K)
    tap group z takes taps [z * kc, (z + 1) * kc) and sums them over all
    of the block's items; other K take passes of ``kc`` taps and add each
    item's passes into the thread's slots. The block adds its row groups
    in order 0..G-1 into its partial. With ``cluster`` (K_WIDE) the
    tile's splits are one thread-block cluster: each block stores its
    partial of output i in the shared memory of block i % splits, which
    adds the ``splits`` partials in split order; otherwise the tile's last
    block adds them in split order from the workspace. Either rounds
    once.
    ``ws_floats`` is the workspace: W_MAX_CTILES tickets, then (without
    ``cluster``) n_ctiles x splits x K x c_tile partials."""

    route: str            # "tma", "cp.async" or "element"
    copy_bytes: int       # 0 on the TMA route, else 2, 4 or 8
    c_tile: int
    n_ctiles: int
    t_out: int
    q: int                # items per batch row
    rows: int             # output rows per item, at most W_ROWS
    x_rows: int           # x window per item: rows + K - 1
    n_items: int
    per: int              # items per block
    splits: int           # blocks per channel tile
    one_pass: bool        # a compile-time K: sums in registers
    kc: int               # taps a thread sums at once (a pass)
    tap_groups: int       # threads that share a row, each with kc taps
    cluster: bool         # the splits of a channel tile are a cluster
    grid: tuple[int, int]
    block: tuple[int, int, int]  # (channel vectors, row groups, tap groups)
    smem_bytes: int
    ws_floats: int


@functools.lru_cache(maxsize=1024)
def wgrad_plan(batch: int, t_in: int, c: int, k: int, itemsize: int, *,
               x_ptr: int = 0, dy_ptr: int = 0,
               num_sms: int = H100_SMS) -> WgradPlan:
    """The launch of openeat_dwconv1d_wgrad for x [batch, t_in, C] and dy
    [batch, t_in - K + 1, C] at the addresses x_ptr and dy_ptr (mod 16 is
    enough): the route (:func:`pick_route`, fitting both) and what the C
    launcher derives from the same constants. Raises ValueError for what
    the kernel does not take."""
    if itemsize not in (2, 4):
        raise ValueError(f"wgrad kernel takes 2- or 4-byte elements, not "
                         f"{itemsize}")
    t_out = t_in - k + 1
    if batch < 1 or c < 1 or k < 1 or t_out < 1:
        raise ValueError(f"empty wgrad problem: B={batch}, T_in={t_in}, "
                         f"C={c}, K={k}")
    route, copy_bytes = pick_route(c * itemsize, itemsize, x_ptr, dy_ptr)
    one_pass = k in (K_FIXED, K_WIDE)
    cluster = k == K_WIDE
    tap_groups = W_TAP_GROUPS if cluster else 1
    groups = W_WIDE_GROUPS if cluster else W_GROUPS
    c_tile = channel_tile(c, itemsize, W_WIDE_C_TILE if cluster else W_C_TILE)
    n_ctiles = -(-c // c_tile)
    # items of at most W_ROWS rows (K_WIDE: W_WIDE_ROWS, and at least
    # W_CLUSTER // batch items a batch row), shorter where a large K
    # leaves less shared memory for the ring
    q = -(-t_out // (W_WIDE_ROWS if cluster else W_ROWS))
    if cluster:
        q = max(q, W_CLUSTER // batch)
    while True:
        rows = -(-t_out // q)
        x_rows = rows + k - 1
        x_bytes = -(-x_rows * c_tile * itemsize // 128) * 128
        stage_bytes = x_bytes + -(-rows * c_tile * itemsize // 128) * 128
        smem = 128 + W_STAGES * stage_bytes + groups * k * c_tile * 4 \
            + W_STAGES * 8 + 8 \
            + ((k * c_tile // VEC + W_CLUSTER) * 16 if cluster else 0)
        if smem <= SMEM_MAX or rows == 1:
            break
        q += 1
    q = -(-t_out // rows)  # no empty item
    n_items = batch * q
    if cluster:
        per = -(-n_items // W_CLUSTER)
    else:
        target = -(-W_BLOCKS_PER_SM * num_sms // n_ctiles)
        per = max(-(-n_items // target), -(-n_items // 65535))
    if n_items >= 2 ** 31 or x_rows > MAX_BOX or smem > SMEM_MAX \
            or n_ctiles > W_MAX_CTILES:
        raise ValueError(f"wgrad kernel does not take B={batch}, "
                         f"T_in={t_in}, C={c}, K={k}: {n_items} items, "
                         f"{x_rows} window rows, {smem} bytes of shared "
                         f"memory, {n_ctiles} channel tiles")
    splits = -(-n_items // per)
    return WgradPlan(
        route=route, copy_bytes=copy_bytes, c_tile=c_tile, n_ctiles=n_ctiles,
        t_out=t_out, q=q, rows=rows, x_rows=x_rows, n_items=n_items, per=per,
        splits=splits, one_pass=one_pass,
        kc=-(-k // tap_groups) if one_pass else W_KC, tap_groups=tap_groups,
        cluster=cluster, grid=(n_ctiles, splits),
        block=(c_tile // VEC, groups, tap_groups), smem_bytes=smem,
        ws_floats=W_MAX_CTILES
        + (0 if cluster else n_ctiles * splits * k * c_tile))


# The plan's fields in the order openeat_dwconv1d_wgrad_plan writes them
# (the row groups are block[1])
WGRAD_PLAN_FIELDS = ("c_tile", "n_ctiles", "rows", "q", "n_items", "per",
                     "splits", "x_rows", "smem_bytes", "kc", "tap_groups",
                     "groups", "cluster", "ws_floats")


def wgrad_plan_fields(plan: WgradPlan) -> tuple[int, ...]:
    """`plan` as the integers openeat_dwconv1d_wgrad_plan gives."""
    return tuple(int(plan.block[1] if f == "groups" else getattr(plan, f))
                 for f in WGRAD_PLAN_FIELDS)


# One wgrad workspace per device, grown on demand and reused by every call
# on it (the calls of one device run in stream order). Allocated zeroed:
# the tickets at its head are 0 between launches. A grown-out workspace
# is kept, since a CUDA graph may hold its address.
_WORKSPACE: dict[int, list[torch.Tensor]] = {}


def _workspace(device: torch.device, n_floats: int) -> torch.Tensor:
    held = _WORKSPACE.setdefault(device.index, [])
    if not held or held[-1].numel() < n_floats:
        size = max(n_floats, 2 * held[-1].numel()) if held else n_floats
        held.append(torch.zeros((size,), dtype=torch.float32, device=device))
    return held[-1]


_WGRAD_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_longlong, ctypes.c_void_p) \
    + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)


def depthwise_conv1d_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dw [K, C] in x's dtype from x [B, T+K-1, C] and dy [B, T, C] of the
    same dtype. A CUDA tensor runs the wgrad kernel, one launch by
    :func:`wgrad_plan` (each adds one to
    ``depthwise_conv1d_wgrad.launches``), with the device's shared
    workspace: calls on one device must share a stream. A CPU tensor
    takes :func:`depthwise_conv1d_wgrad_plain`."""
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
    plan = wgrad_plan(b, tp, c, k, x.element_size(),
                      x_ptr=x.data_ptr() % 16, dy_ptr=dy.data_ptr() % 16,
                      num_sms=_num_sms(x.device.index))
    ws = _workspace(x.device, plan.ws_floats)
    dw = torch.empty((k, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device), \
            nvcc.launch_region("openeat_dwconv1d_wgrad"):
        _count(depthwise_conv1d_wgrad, x.shape, k, x.dtype)
        rc = _entry("openeat_dwconv1d_wgrad", _WGRAD_ARGS)(
            x.data_ptr(), dy.data_ptr(), ws.data_ptr(), ws.numel(),
            dw.data_ptr(), b, tp, c, k, _DTYPE_CODE[x.dtype],
            plan.copy_bytes, _stream(x))
    if rc != 0:
        raise RuntimeError(f"depthwise_conv1d wgrad launch failed with code "
                           f"{rc} ({plan})")
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


for _wrapper in (depthwise_conv1d, depthwise_conv1d_dgrad,
                 depthwise_conv1d_wgrad):
    _wrapper.launches = 0
    _wrapper.shape_launches = {}
