"""CTC loss: the hand-written CUDA forward-backward kernels K1 and K2,
their plain PyTorch version, and the autograd Function around them.

Port of openeat_tpu/ops/ctc_loss.py. The TPU kernels it replaces are
``_ctc_dp_kernel_batched`` (K1, launched by ``_ctc_pallas_batched``) and
``_ctc_dp_kernel`` (K2, launched by ``_ctc_pallas``): log-space alpha and
beta over blank-interleaved labels, giving ``loss = -logZ`` and
``gamma = alpha + beta - logZ``. The gather of label_logp [B, T, S] from
log_probs [B, T, V] and the scatter of exp(gamma) back into the [B, T, V]
gradient are XLA ops around the kernel in JAX and torch ops here.

On Hopper the two are one recurrence (openeat_torch/csrc/ctc_loss.cu):
one block per utterance, threads over S, T walked in order. K1's
counterpart keeps alpha's [T, S] history in shared memory; K2's keeps it
in device memory for the tall T x S that do not fit.
:func:`dispatch_variant` picks between them from the H100's shared memory
per block. The kernels are bound by latency (2*T dependent steps), not by
the bytes they move.

``ctc_forward_scan``/``ctc_backward_scan`` are the plain version: the
same recursions as loops over T on [B, S] tensors. One deliberate
difference from the JAX scan oracle: logZ counts the end positions
s_len-1 and max(s_len-2, 0) once each, as the JAX kernels do; the scan
oracle counts position 0 twice when a label sequence is empty (s_len 1).
"""

from __future__ import annotations

import ctypes

import torch

from openeat_torch.ops import nvcc

SOURCE = "ctc_loss.cu"
NEG_INF = -1.0e30
# H100: 227 KB (232,448 bytes) of shared memory per block, less the
# kernel's static shared memory and a margin
SMEM_BUDGET = 232448 - 1024
MAX_S = 1024  # one thread per label position


def extended_labels(labels: torch.Tensor, label_lens: torch.Tensor,
                    blank_id: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """labels [B, L] -> blank-interleaved z [B, S=2L+1], valid S lens."""
    b, l = labels.shape
    z = torch.full((b, 2 * l + 1), blank_id, dtype=torch.long,
                   device=labels.device)
    z[:, 1::2] = labels.long()
    return z, 2 * label_lens.long() + 1


def transition_masks(z: torch.Tensor) -> torch.Tensor:
    """allow2 [B, S]: True where the skip s-2 -> s is legal (position s
    is a label and z[s] != z[s-2])."""
    b, s = z.shape
    blank_pos = (torch.arange(s, device=z.device) % 2) == 0
    z_m2 = torch.cat([z.new_full((b, 2), -1), z[:, :-2]], dim=1)
    return ~blank_pos[None, :] & (z != z_m2)


def _lae3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, torch.maximum(b, c))
    dead = m <= NEG_INF
    ms = torch.where(dead, 0.0, m)
    out = ms + torch.log(torch.exp(a - ms) + torch.exp(b - ms)
                         + torch.exp(c - ms))
    return torch.where(dead, NEG_INF, out)


def ctc_forward_scan(label_logp: torch.Tensor, input_lens: torch.Tensor,
                     s_lens: torch.Tensor, allow2: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Alpha recursion. label_logp [B, T, S] float32. Returns (loss [B],
    alphas [B, T, S]); alpha is frozen past each input length."""
    b, t, s = label_logp.shape
    pos = torch.arange(s, device=label_logp.device)[None, :]
    lens = input_lens.long()[:, None]
    alpha = torch.where((pos < 2) & (pos < s_lens[:, None]),
                        label_logp[:, 0], NEG_INF)
    pad1 = alpha.new_full((b, 1), NEG_INF)
    pad2 = alpha.new_full((b, 2), NEG_INF)
    alphas = [alpha]
    for i in range(1, t):
        a1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a2 = torch.where(allow2, torch.cat([pad2, alpha[:, :-2]], dim=1),
                         NEG_INF)
        new = _lae3(alpha, a1, a2) + label_logp[:, i]
        alpha = torch.where(i < lens, new, alpha)
        alphas.append(alpha)
    alphas = torch.stack(alphas, dim=1)
    rows = torch.arange(b, device=label_logp.device)
    # alpha is frozen past len, so the last row is alpha at len-1;
    # len == 0 has no frame and no path
    last = torch.where(lens >= 1, alphas[:, -1], NEG_INF)
    end1 = last[rows, s_lens - 1]
    end2 = last[rows, (s_lens - 2).clamp(min=0)]
    end2 = torch.where(s_lens >= 2, end2, NEG_INF)
    logz = _lae3(end1, end2, torch.full_like(end1, NEG_INF))
    return -logz, alphas


def ctc_backward_scan(label_logp: torch.Tensor, input_lens: torch.Tensor,
                      s_lens: torch.Tensor, allow2: torch.Tensor
                      ) -> torch.Tensor:
    """Beta recursion (time-reversed). beta[t, s] excludes frame t's own
    emission, so alpha + beta - logZ is the posterior; reset at len-1
    and held past it. Returns betas [B, T, S]."""
    b, t, s = label_logp.shape
    pos = torch.arange(s, device=label_logp.device)[None, :]
    lens = input_lens.long()[:, None]
    end_mask = (pos == (s_lens - 1)[:, None]) \
        | (pos == (s_lens - 2).clamp(min=0)[:, None])
    beta_init = torch.where(end_mask, 0.0, NEG_INF).to(label_logp.dtype)
    allow2_f = torch.cat([allow2[:, 2:], allow2.new_zeros((b, 2))], dim=1)
    pad1 = beta_init.new_full((b, 1), NEG_INF)
    pad2 = beta_init.new_full((b, 2), NEG_INF)
    beta = beta_init
    betas = [beta]
    for i in range(t - 2, -1, -1):
        bnext = beta + label_logp[:, i + 1]
        b1 = torch.cat([bnext[:, 1:], pad1], dim=1)
        b2 = torch.where(allow2_f, torch.cat([bnext[:, 2:], pad2], dim=1),
                         NEG_INF)
        new = _lae3(bnext, b1, b2)
        new = torch.where(i == lens - 1, beta_init, new)
        beta = torch.where(i > lens - 1, beta, new)
        betas.append(beta)
    return torch.stack(betas[::-1], dim=1)


def ctc_dp_plain(label_logp: torch.Tensor, input_lens: torch.Tensor,
                 s_lens: torch.Tensor, allow2: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss [B], gamma [B, T, S]) from the plain recursions; gamma is
    NEG_INF at t >= len, as the kernels write it."""
    loss, alphas = ctc_forward_scan(label_logp, input_lens, s_lens, allow2)
    betas = ctc_backward_scan(label_logp, input_lens, s_lens, allow2)
    gamma = alphas + betas + loss[:, None, None]
    t = label_logp.shape[1]
    valid = torch.arange(t, device=gamma.device)[None, :, None] \
        < input_lens.long()[:, None, None]
    return loss, torch.where(valid, gamma, NEG_INF)


def dispatch_variant(b: int, t: int, s: int) -> str:
    """Which kernel a [B, T, S] problem goes to on the H100: "shared"
    (K1's counterpart) when alpha's T x S float32 history and two rows
    fit the shared memory of one block, else "global" (K2's). The batch
    size does not enter: each utterance is its own block."""
    if s > MAX_S:
        raise ValueError(f"CTC kernel takes S = 2L+1 <= {MAX_S}; got {s}")
    if (t * s + 2 * s) * 4 <= SMEM_BUDGET:
        return "shared"
    return "global"


def _launch(label_logp, input_lens, s_lens, allow2, smem_hist: bool):
    b, t, s = label_logp.shape
    dispatch_variant(b, t, s)   # raises for S > MAX_S
    lib = nvcc.load_library(SOURCE)
    fn = lib.openeat_ctc_dp
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = label_logp.device
    lp = label_logp.float().contiguous()
    il = input_lens.to(device=dev, dtype=torch.int32).contiguous()
    sl = s_lens.to(device=dev, dtype=torch.int32).contiguous()
    a2 = allow2.to(device=dev, dtype=torch.uint8).contiguous()
    loss = torch.empty((b,), dtype=torch.float32, device=dev)
    gamma = torch.empty((b, t, s), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(lp.data_ptr(), il.data_ptr(), sl.data_ptr(), a2.data_ptr(),
                loss.data_ptr(), gamma.data_ptr(), b, t, s, int(smem_hist),
                stream)
    if rc != 0:
        raise RuntimeError(f"CTC kernel launch failed: cudaError {rc}")
    return loss, gamma


def ctc_dp_shared(label_logp, input_lens, s_lens, allow2):
    """K1's counterpart: alpha history in shared memory. CUDA only;
    every launch adds one to ``ctc_dp_shared.launches``."""
    _check_cuda(label_logp)
    if dispatch_variant(*label_logp.shape) != "shared":
        raise ValueError(f"alpha history of {tuple(label_logp.shape)} does "
                         "not fit shared memory; use ctc_dp_global")
    ctc_dp_shared.launches += 1
    return _launch(label_logp, input_lens, s_lens, allow2, True)


def ctc_dp_global(label_logp, input_lens, s_lens, allow2):
    """K2's counterpart: alpha history in device memory. CUDA only;
    every launch adds one to ``ctc_dp_global.launches``."""
    _check_cuda(label_logp)
    ctc_dp_global.launches += 1
    return _launch(label_logp, input_lens, s_lens, allow2, False)


ctc_dp_shared.launches = 0
ctc_dp_global.launches = 0


def _check_cuda(label_logp: torch.Tensor) -> None:
    if label_logp.device.type != "cuda":
        raise ValueError(f"CTC kernel wants a CUDA tensor; got "
                         f"{label_logp.device}")
    if label_logp.dim() != 3:
        raise ValueError(f"label_logp must be [B, T, S]; got "
                         f"{tuple(label_logp.shape)}")


def ctc_dp(label_logp: torch.Tensor, input_lens: torch.Tensor,
           s_lens: torch.Tensor, allow2: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss [B], gamma [B, T, S]). A CPU tensor takes the plain
    version; a CUDA tensor takes the kernel :func:`dispatch_variant`
    names."""
    if label_logp.device.type == "cpu":
        return ctc_dp_plain(label_logp, input_lens, s_lens, allow2)
    if dispatch_variant(*label_logp.shape) == "shared":
        return ctc_dp_shared(label_logp, input_lens, s_lens, allow2)
    return ctc_dp_global(label_logp, input_lens, s_lens, allow2)


def gather_label_logp(log_probs: torch.Tensor,
                      z: torch.Tensor) -> torch.Tensor:
    """log_probs [B, T, V], z [B, S] -> float32 [B, T, S]."""
    t = log_probs.shape[1]
    return log_probs.float().gather(
        2, z[:, None, :].expand(-1, t, -1))


class _CTCLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, input_lens, labels, label_lens, blank_id):
        z, s_lens = extended_labels(labels, label_lens, blank_id)
        allow2 = transition_masks(z)
        label_logp = gather_label_logp(log_probs, z)
        loss, gamma = ctc_dp(label_logp, input_lens, s_lens, allow2)
        ctx.save_for_backward(gamma, z, input_lens)
        ctx.shape = log_probs.shape
        ctx.dtype = log_probs.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        gamma, z, input_lens = ctx.saved_tensors
        b, t, v = ctx.shape
        # the clamp keeps an infeasible sequence's posteriors <= 1, so
        # the caller's feasibility mask (a zero g) gives 0, not NaN;
        # repeated labels hit the same v, hence scatter_add
        post = torch.exp(torch.clamp(gamma, max=0.0))
        grad = torch.zeros((b, t, v), dtype=torch.float32,
                           device=gamma.device)
        grad.scatter_add_(2, z[:, None, :].expand(-1, t, -1), post)
        grad = -grad * g.float()[:, None, None]
        valid = torch.arange(t, device=grad.device)[None, :, None] \
            < input_lens.long()[:, None, None]
        grad = torch.where(valid, grad, 0.0)
        return grad.to(ctx.dtype), None, None, None, None


def ctc_loss(log_probs: torch.Tensor, input_lens: torch.Tensor,
             labels: torch.Tensor, label_lens: torch.Tensor,
             blank_id: int = 0) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood.

    log_probs [B, T, V] (log-softmax); labels [B, L]. Returns loss [B];
    an infeasible alignment gives about 1e30 (mask it as the CTC head
    does, like zero_infinity)."""
    return _CTCLoss.apply(log_probs, input_lens, labels, label_lens,
                          blank_id)
