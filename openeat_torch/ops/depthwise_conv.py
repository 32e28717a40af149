"""Depthwise 1-D convolution: the hand-written CUDA kernel K3 and its
plain PyTorch version.

Port of openeat_tpu/ops/depthwise_conv.py. The TPU kernel it replaces is
``_kernel`` there (launched by ``_pallas_dwconv``): a VALID depthwise
conv of a caller-padded x [B, T+K-1, C] with taps w [K, C], accumulated
in float32 over the K taps in order, output in x's dtype, no bias.

The CUDA kernel (openeat_torch/csrc/depthwise_conv.cu) is bound by
device-memory bytes: it must read x and w once and write out once,
(B*(T+K-1)*C + K*C + B*T*C) * itemsize bytes — about 2.1 MB at the
float32 decode shape [8, 124+14, 256], K=15 — against 2*B*T*C*K flops.
Threads run along the channel-minor axis so loads coalesce, and each
block stages its input tile with the K-1 halo in shared memory, so x is
read from device memory about once.

Only the forward pass is ported; the backward kernel (dgrad on
tap-reversed w, and wgrad) comes with training.
"""

from __future__ import annotations

import ctypes

import torch

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


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID depthwise conv. x: [B, T+K-1, C] (padded by the caller for
    causal or symmetric semantics); w: [K, C]. Returns [B, T, C] in
    x.dtype.

    A CUDA tensor goes to the CUDA kernel (built on first use); a CPU
    tensor goes to :func:`depthwise_conv1d_plain`. Every kernel launch
    adds one to ``depthwise_conv1d.launches``."""
    _check(x, w)
    if x.device.type == "cpu":
        return depthwise_conv1d_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv1d: unsupported device {x.device}")
    b, tp, c = x.shape
    k = w.shape[0]
    if b > 65535 or k > 64:
        raise ValueError(f"depthwise_conv1d kernel takes B <= 65535 and "
                         f"K <= 64; got B={b}, K={k}")
    lib = nvcc.load_library(SOURCE)
    fn = lib.openeat_dwconv1d_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((b, tp - k + 1, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        depthwise_conv1d.launches += 1
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, tp, c, k,
                _DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"depthwise_conv1d kernel launch failed: "
                           f"cudaError {rc}")
    return out


depthwise_conv1d.launches = 0
