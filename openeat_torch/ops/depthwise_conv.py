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

All three are bound by device-memory bytes. The forward must read x and
w once and write out once, (B*(T+K-1)*C + K*C + B*T*C) * itemsize bytes
— about 2.1 MB at the float32 decode shape [8, 124+14, 256], K=15 —
against 2*B*T*C*K flops. Threads run along the channel-minor axis so
loads coalesce, and each block stages its input tile with the K-1 halo in
shared memory, so x is read from device memory about once. wgrad writes
per-block partial sums and adds them in a second pass in a fixed order
(no float atomics), so two runs give the same bits.

:func:`depthwise_conv1d` is a ``torch.autograd.Function`` on both
devices: a CUDA tensor runs the kernels forward and backward, a CPU
tensor runs the plain versions of the same formulas, so the CPU tests
exercise the backward that the card runs.
"""

from __future__ import annotations

import ctypes

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


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"depthwise_conv1d wants x [B, T+K-1, C] and "
                         f"w [K, C]; got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.shape[1] < w.shape[0]:
        raise ValueError(f"input length {x.shape[1]} < kernel {w.shape[0]}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"depthwise_conv1d takes float32 or bfloat16 x and "
                        f"w of the same dtype; got {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("depthwise_conv1d needs contiguous x and w")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"depthwise_conv1d: unsupported device {x.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K3 on the card: x [B, T+K-1, C], w [K, C] -> [B, T, C]."""
    b, tp, c = x.shape
    k = w.shape[0]
    if b > 65535 or k > 64:
        raise ValueError(f"depthwise_conv1d kernel takes B <= 65535 and "
                         f"K <= 64; got B={b}, K={k}")
    fn = nvcc.load_library(SOURCE).openeat_dwconv1d_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((b, tp - k + 1, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, tp, c, k,
                _DTYPE_CODE[x.dtype], _stream(x))
    if rc != 0:
        raise RuntimeError(f"depthwise_conv1d kernel launch failed: "
                           f"cudaError {rc}")
    return out


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return depthwise_conv1d_plain(x, w)
    depthwise_conv1d.launches += 1
    return _launch_forward(x, w)


def depthwise_conv1d_dgrad(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx [B, T+K-1, C] in dy's dtype. A CUDA tensor runs K3 on the
    padded dy with reversed taps (each launch adds one to
    ``depthwise_conv1d_dgrad.launches``); a CPU tensor takes
    :func:`depthwise_conv1d_dgrad_plain`."""
    dy_pad = _pad_dy(dy, w.shape[0])
    w_rev = w.flip(0).to(dy.dtype).contiguous()
    _check(dy_pad, w_rev)
    if dy.device.type == "cpu":
        return depthwise_conv1d_plain(dy_pad, w_rev)
    depthwise_conv1d_dgrad.launches += 1
    return _launch_forward(dy_pad, w_rev)


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
    lib = nvcc.load_library(SOURCE)
    scratch = lib.openeat_dwconv1d_wgrad_scratch
    scratch.argtypes = [ctypes.c_int] * 4
    scratch.restype = ctypes.c_longlong
    fn = lib.openeat_dwconv1d_wgrad
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
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
    _check(x, w)
    return _DepthwiseConv1d.apply(x, w)


depthwise_conv1d.launches = 0
depthwise_conv1d_dgrad.launches = 0
depthwise_conv1d_wgrad.launches = 0
