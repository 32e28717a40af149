"""Batched CTC prefix beam search (PyTorch).
Port of openeat_tpu/decode/ctc_prefix_beam.py; the tokens equal the JAX
search's exactly.

Each frame expands K prefixes into K "stay" candidates (blank or the
repeated last token) and K*C extensions by the frame's top-C tokens,
merges equal prefixes, which are found by sorting on two independent
32-bit rolling hashes, by log-adding their masses, and keeps the best K.
Frames past an utterance's length are identity steps.

Matching the JAX search bit for bit takes:
- the uint32 hashes, which wrap mod 2**32, kept in int64 and masked with
  0xFFFFFFFF, with products split so that no int64 overflows;
- `jnp.lexsort((-score, h2, h1))` as three stable sorts, least
  significant key first;
- `lax.top_k`, which breaks ties by the lower index, as a stable
  descending sort (torch.topk promises no order among ties);
- the NEG_INF = -1e30 sentinel where the JAX code has it.
"""

from __future__ import annotations

import torch

from openeat_torch.utils.common import IGNORE_ID

NEG_INF = -1.0e30
_MASK32 = 0xFFFFFFFF
_H1_MUL = 1000003
_H2_MUL = 2654435761
_JUNK = 0x9E3779B9


def _mul_u32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2**32 for 0 <= h < 2**32 held in int64, computed in
    16-bit halves of m so no intermediate exceeds 2**49."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mx = torch.maximum(a, b)
    dead = mx <= NEG_INF
    mx_safe = torch.where(dead, 0.0, mx)
    out = mx_safe + torch.log(torch.exp(a - mx_safe) + torch.exp(b - mx_safe))
    return torch.where(dead, NEG_INF, out)


def _segment_logsumexp(vals: torch.Tensor, seg_ids: torch.Tensor,
                       n: int) -> torch.Tensor:
    """Per-row log-sum-exp of vals [B, N] over segment ids [B, N] < n."""
    mx = vals.new_full((vals.shape[0], n), -float("inf")).scatter_reduce(
        1, seg_ids, vals, "amax")
    mx = torch.where(mx <= NEG_INF, 0.0, mx)
    s = torch.zeros_like(mx).scatter_add(
        1, seg_ids, torch.exp(vals - mx.gather(1, seg_ids)))
    out = mx + torch.log(torch.clamp(s, min=1e-38))
    return torch.where(s <= 0.0, NEG_INF, out)


def _top_k(x: torch.Tensor, k: int):
    """lax.top_k over the last dim: values and indices, ties by index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _lexsort(keys) -> torch.Tensor:
    """jnp.lexsort along dim 1: the last key is the primary one."""
    b, n = keys[0].shape
    order = torch.arange(n, device=keys[0].device).expand(b, n)
    for key in keys:
        _, o = torch.sort(key.gather(1, order), dim=1, stable=True)
        order = order.gather(1, o)
    return order


class BeamState:
    """Per-utterance beams, batched: prefixes [B, K, L] (IGNORE_ID
    padded), lens/last/h1/h2 [B, K] int64, pb/pnb [B, K] float32."""

    def __init__(self, batch: int, beam_size: int, max_hyp_len: int,
                 device):
        k = beam_size
        i64 = dict(dtype=torch.long, device=device)
        self.prefixes = torch.full((batch, k, max_hyp_len), IGNORE_ID, **i64)
        self.lens = torch.zeros((batch, k), **i64)
        self.last = torch.full((batch, k), -1, **i64)
        self.h1 = torch.zeros((batch, k), **i64)
        self.h2 = torch.zeros((batch, k), **i64)
        self.pb = torch.full((batch, k), NEG_INF, device=device)
        self.pb[:, 0] = 0.0
        self.pnb = torch.full((batch, k), NEG_INF, device=device)


def prefix_beam_step(st: BeamState, lp: torch.Tensor, active: torch.Tensor,
                     blank_id: int = 0) -> None:
    """One frame for every utterance, in place. lp: [B, V] log-probs;
    active: [B] bool, False makes the frame an identity step."""
    b, k, max_len = st.prefixes.shape
    c = k  # first-stage prune width
    n_cand = k * (c + 1)
    dev = lp.device
    idle = torch.full_like(lp, NEG_INF)
    idle[:, blank_id] = 0.0
    lp = torch.where(active[:, None], lp, idle)
    top_lp, top_v = _top_k(lp, c)                                # [B, C]

    # stay candidates: the repeated last token only counts when it
    # survives the frame's top-C prune, and so does blank
    last_in_top = (top_v[:, None, :] == st.last[:, :, None]).any(-1)
    lp_last = torch.where((st.last >= 0) & last_in_top,
                          lp.gather(1, st.last.clamp(min=0)), NEG_INF)
    blank_in_top = (top_v == blank_id).any(-1, keepdim=True)     # [B, 1]
    lp_blank = torch.where(blank_in_top, lp[:, blank_id:blank_id + 1],
                           NEG_INF)
    p_all = _logaddexp(st.pb, st.pnb)
    stay_pb = p_all + lp_blank
    stay_pnb = st.pnb + lp_last

    # extension candidates [B, K, C]
    is_blank = (top_v == blank_id)[:, None, :]
    same_as_last = top_v[:, None, :] == st.last[:, :, None]
    base = torch.where(same_as_last, st.pb[..., None], p_all[..., None])
    dead = is_blank | (st.lens >= max_len)[..., None]
    ext_pnb = torch.where(dead, NEG_INF, base + top_lp[:, None, :])
    vv = top_v[:, None, :] + 1
    junk = torch.arange(k * c, device=dev).view(k, c) + _JUNK
    ext_h1 = torch.where(dead, junk, (_mul_u32(st.h1[..., None], _H1_MUL)
                                      + vv) & _MASK32)
    ext_h2 = torch.where(dead, junk, (_mul_u32(st.h2[..., None], _H2_MUL)
                                      + vv * 97) & _MASK32)

    # flatten: K stay candidates, then K*C extensions
    cand_pb = torch.cat([stay_pb, torch.full((b, k * c), NEG_INF,
                                             device=dev)], 1)
    cand_pnb = torch.cat([stay_pnb, ext_pnb.reshape(b, -1)], 1)
    cand_h1 = torch.cat([st.h1, ext_h1.reshape(b, -1)], 1)
    cand_h2 = torch.cat([st.h2, ext_h2.reshape(b, -1)], 1)
    ar_k = torch.arange(k, device=dev)
    cand_parent = torch.cat([ar_k, ar_k.repeat_interleave(c)])[None]
    cand_tok = torch.cat([torch.full((b, k), -1, dtype=torch.long,
                                     device=dev), top_v.repeat(1, k)], 1)

    # merge equal prefixes; each segment's first candidate is its
    # highest-mass one
    order = _lexsort([-_logaddexp(cand_pb, cand_pnb), cand_h2, cand_h1])
    s_pb, s_pnb = cand_pb.gather(1, order), cand_pnb.gather(1, order)
    s_h1, s_h2 = cand_h1.gather(1, order), cand_h2.gather(1, order)
    s_parent = cand_parent.expand(b, -1).gather(1, order)
    s_tok = cand_tok.gather(1, order)
    new_seg = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev),
                         (s_h1[:, 1:] != s_h1[:, :-1])
                         | (s_h2[:, 1:] != s_h2[:, :-1])], 1)
    seg_ids = torch.cumsum(new_seg, 1) - 1
    m_pb = _segment_logsumexp(s_pb, seg_ids, n_cand)
    m_pnb = _segment_logsumexp(s_pnb, seg_ids, n_cand)
    ar_n = torch.arange(n_cand, device=dev).expand(b, n_cand)
    rep = torch.full((b, n_cand), n_cand, dtype=torch.long,
                     device=dev).scatter_reduce(
        1, seg_ids, torch.where(new_seg, ar_n, n_cand), "amin")
    rep = rep.clamp(max=n_cand - 1)
    seg_alive = ar_n < seg_ids[:, -1:] + 1
    score = torch.where(seg_alive, _logaddexp(m_pb, m_pnb), NEG_INF)

    # keep the top K
    _, top_seg = _top_k(score, k)
    sel = rep.gather(1, top_seg)
    parent = s_parent.gather(1, sel)
    tok = s_tok.gather(1, sel)
    prefixes = st.prefixes.gather(1, parent[..., None].expand(-1, -1, max_len))
    lens = st.lens.gather(1, parent)
    last = st.last.gather(1, parent)
    h1, h2 = st.h1.gather(1, parent), st.h2.gather(1, parent)
    extend = tok >= 0
    pos = lens.clamp(max=max_len - 1)[..., None]
    cur = prefixes.gather(2, pos)[..., 0]
    prefixes.scatter_(2, pos, torch.where(extend, tok, cur)[..., None])
    tu = tok + 1
    st.prefixes = prefixes
    st.lens = torch.where(extend, lens + 1, lens)
    st.last = torch.where(extend, tok, last)
    st.h1 = torch.where(extend, (_mul_u32(h1, _H1_MUL) + tu) & _MASK32, h1)
    st.h2 = torch.where(extend, (_mul_u32(h2, _H2_MUL) + tu * 97) & _MASK32,
                        h2)
    st.pb = m_pb.gather(1, top_seg)
    st.pnb = m_pnb.gather(1, top_seg)


def ctc_prefix_beam_search(ctc_log_probs: torch.Tensor, lens: torch.Tensor,
                           beam_size: int = 10, max_hyp_len: int = 64,
                           blank_id: int = 0):
    """ctc_log_probs: [B, T, V]; lens: [B].
    Returns (prefixes [B, K, max_hyp_len] IGNORE_ID padded, prefix_lens
    [B, K], scores [B, K]), best first."""
    b, t_max, _ = ctc_log_probs.shape
    st = BeamState(b, beam_size, max_hyp_len, ctc_log_probs.device)
    for t in range(t_max):
        prefix_beam_step(st, ctc_log_probs[:, t], t < lens, blank_id)
    scores = _logaddexp(st.pb, st.pnb)
    _, order = torch.sort(-scores, dim=1, stable=True)
    return (st.prefixes.gather(1, order[..., None].expand(-1, -1,
                                                          max_hyp_len)),
            st.lens.gather(1, order), scores.gather(1, order))
