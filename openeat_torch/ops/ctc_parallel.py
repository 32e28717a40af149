"""Parallel-in-time CTC loss: a log-semiring product of the per-frame
transition matrices, in plain torch ops.
Port of openeat_tpu/ops/ctc_parallel.py (`ctc_impl: parallel`).

The CTC alpha recursion is a linear recurrence in the (log, +)
semiring, alpha_t = M_t (x) alpha_{t-1} with (M (x) v)[i] =
LSE_j(M[i, j] + v[j]), so the T-step chain is one product of banded
[S, S] matrices. It is folded in ceil(log2 T) rounds of batched
log-matmuls, each pair of neighbours combined at once (the JAX module
takes the last element of an associative scan: the same product,
associated in another order), instead of T dependent steps. Each
combine factors out the row and column maxima,

    LSE_k(A[i, k] + B[k, j]) = a_i + log(exp(A - a) @ exp(B - b))_ij + b_j,

so its inner product is a real matmul of operands <= 1. This is
not a port of a TPU kernel: the JAX module runs outside any Pallas
kernel, and so does this one (torch.matmul). Autograd gives the
gradient.

One change from the JAX module. Its float32 product underflows when
the row's maximum and the column's sit at different k, e^-88 apart, and
it clamps the product at 1e-30, which gives am + bm - 69: a path that
does not exist. Over a few hundred frames these add up, and the loss
comes out low (tests/test_torch_ctc_parallel.py). Here the product's
exponentials and matmul are float64 (e^-708 of range), and a product
that still underflows is the semiring zero NEG. Wherever the JAX
product does not underflow, as at the JAX package's own test shapes,
the two compute the same function (to float32 rounding).
"""

from __future__ import annotations

import torch

# -1e9, not -1e30: the semiring's zeros add up through log2(T) levels of
# combines, and 1e30-scale values overflow float32 in the backward
NEG = -1e9


def _log_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LSE_k(a[..., i, k] + b[..., k, j]) through the max-shift matmul,
    its product in float64; NEG where that underflows."""
    am = a.amax(dim=-1, keepdim=True)              # [..., S, 1]
    bm = b.amax(dim=-2, keepdim=True)              # [..., 1, S]
    prod = torch.matmul(torch.exp((a - am).double()),
                        torch.exp((b - bm).double()))
    tiny = torch.finfo(prod.dtype).tiny
    log_prod = torch.where(prod >= tiny, torch.log(prod.clamp_min(tiny)),
                           NEG)
    return am + log_prod.to(a.dtype) + bm


def _fold(m: torch.Tensor) -> torch.Tensor:
    """m [N, B, S, S] -> m[N-1] (x) ... (x) m[0]: the later matrix on the
    left, neighbours combined pairwise in each round."""
    while m.shape[0] > 1:
        n = m.shape[0] // 2 * 2
        paired = _log_matmul(m[1:n:2], m[0:n:2])
        m = torch.cat([paired, m[n:]]) if n < m.shape[0] else paired
    return m[0]


def ctc_loss_parallel(logits: torch.Tensor, logit_paddings: torch.Tensor,
                      labels: torch.Tensor, label_paddings: torch.Tensor,
                      blank_id: int = 0) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood [B], optax.ctc_loss's API:
    logits [B, T, V] (unnormalized), logit_paddings [B, T] (1.0 = pad),
    labels [B, L] int, label_paddings [B, L] (1.0 = pad)."""
    b, t, _ = logits.shape
    l = labels.shape[1]
    s = 2 * l + 1
    dev = logits.device
    logp = torch.log_softmax(logits.float(), dim=-1)
    lab_lens = (1.0 - label_paddings).sum(dim=-1).long()

    # state s: even -> blank, odd -> labels[(s - 1) // 2]
    states = torch.arange(s, device=dev)
    odd = states % 2 == 1
    sym = (torch.where(odd[None, :], labels[:, (states // 2).clamp(
        max=max(l - 1, 0))], blank_id) if l > 0
        else torch.full((b, s), blank_id, device=dev)).long()  # [B, S]
    # the skip s - 2 -> s: an odd s >= 2 whose label differs from the
    # one before it
    sym_m2 = torch.cat([torch.full((b, 2), -1, dtype=sym.dtype, device=dev),
                        sym[:, :-2]], dim=1)
    skip_ok = odd[None, :] & (states[None, :] >= 2) & (sym != sym_m2)
    valid = states[None, :] < (2 * lab_lens + 1)[:, None]      # [B, S]

    emit = torch.gather(logp, 2, sym[:, None, :].expand(b, t, s))  # [B,T,S]

    # A[i, j] = 0 where the step j -> i is allowed, else NEG
    stay = states[:, None] == states[None, :]
    step1 = states[:, None] == states[None, :] + 1
    step2 = states[:, None] == states[None, :] + 2
    zero = torch.zeros((), device=dev)
    neg = torch.full((), NEG, device=dev)
    allowed = torch.maximum(
        torch.where(stay | step1, zero, neg)[None],
        torch.where(skip_ok[:, :, None] & step2[None], zero, neg))
    allowed = torch.where(valid[:, :, None] & valid[:, None, :], allowed,
                          neg)                                 # [B, S, S]

    # frame t's matrix M_t[i, j] = emit[t, i] + A[i, j]; a padded frame
    # is the semiring's identity (0 on the diagonal, NEG elsewhere)
    m = emit[:, :, :, None] + allowed[:, None, :, :]           # [B,T,S,S]
    ident = torch.where(stay, zero, neg)
    m = torch.where(logit_paddings[:, :, None, None] > 0.0, ident, m)

    # alpha_0 carries frame 0's emission (start states 0 and 1), so the
    # product folds M_1 .. M_{T-1} only
    alpha0 = torch.full((b, s), NEG, device=dev)
    alpha0[:, 0] = emit[:, 0, 0]
    if l > 0:
        alpha0[:, 1] = torch.where(lab_lens > 0, emit[:, 0, 1], neg)
    if t > 1:
        total = _fold(m[:, 1:].transpose(0, 1))                # [B, S, S]
        alpha_t = _log_matmul(total, alpha0[:, :, None])[:, :, 0]
    else:
        alpha_t = alpha0

    # accepting states: 2 * len (the final blank), 2 * len - 1 (the last
    # label)
    end_blank = torch.gather(alpha_t, 1, (2 * lab_lens)[:, None])[:, 0]
    end_label = torch.gather(alpha_t, 1,
                             (2 * lab_lens - 1).clamp(min=0)[:, None])[:, 0]
    end_label = torch.where(lab_lens > 0, end_label, neg)
    return -torch.logaddexp(end_blank, end_label)
