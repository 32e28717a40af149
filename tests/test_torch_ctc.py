"""openeat_torch CTC (kernels K1/K2) on the CPU.

The CUDA kernels run only on a card (chip_smoke.py holds them against
the plain version there). Here the plain version, which the CPU route of
the autograd Function runs, is held against the JAX package:
- loss within 1e-5 relative and gamma within 1e-4 absolute plus 1e-6
  relative on finite entries (a float32 sum of T terms: gamma reaches
  -300 at T=160, where one ulp is 3e-5), NEG_INF entries equal, against
  the two Pallas kernels in interpret mode and against the scan oracles,
  over repeats, len == 1, infeasible rows, a padded batch, S > 128 and an
  input length above T (walked as T frames, as the scans and
  _ctc_pallas do; _ctc_pallas_batched takes its final alpha row only at
  t == len - 1 and gives logZ = NEG_INF there, so it is left out of that
  case);
- d loss / d log-probs against jax.grad of ops/ctc_loss.ctc_loss, and
  the CTC head's loss and d loss / d encoder states against the JAX
  head with ctc_impl optax (the flagship's loss) and native, within
  1e-4;
- dispatch_variant at the flagship shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openeat_tpu.modules.ctc import CTCHead as FlaxCTCHead
from openeat_tpu.ops import ctc_loss as J
from openeat_tpu.utils.checkpoint import _flatten
from openeat_torch.modules.ctc import CTCHead
from openeat_torch.ops import ctc_loss as P
from openeat_torch.ops import nvcc
from openeat_torch.utils.param_bridge import flax_to_state_dict
from tests._torch_parity import _draw

torch.set_num_threads(1)


def _problem(seed, b, t, v, l, len_override=None, lab_override=None):
    """Log-probs, labels with repeats, input and label lengths."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, v)).astype(np.float32) * 2
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    labels = rng.integers(1, v, (b, l)).astype(np.int32)
    labels[0, 1] = labels[0, 0]                      # a repeat
    il = rng.integers(max(t // 2, 1), t + 1, (b,)).astype(np.int32)
    ll = rng.integers(1, l + 1, (b,)).astype(np.int32)
    il[0], ll[0] = t, l
    for i, n in (len_override or {}).items():
        il[i] = n
    for i, n in (lab_override or {}).items():
        ll[i] = n
    return lp, labels, il, ll


def _jax_label_logp(lp, labels, ll):
    z, s_lens = J.extended_labels(jnp.asarray(labels), jnp.asarray(ll))
    allow2 = J._transition_masks(z)
    llp = jnp.take_along_axis(jnp.asarray(lp),
                              z[:, None, :].repeat(lp.shape[1], axis=1),
                              axis=2)
    return llp, s_lens, allow2


def _port_dp(lp, labels, il, ll):
    z, s_lens = P.extended_labels(torch.from_numpy(labels),
                                  torch.from_numpy(ll))
    allow2 = P.transition_masks(z)
    llp = P.gather_label_logp(torch.from_numpy(lp), z)
    loss, gamma = P.ctc_dp(llp, torch.from_numpy(il), s_lens, allow2)
    return loss.numpy(), gamma.numpy()


def _assert_dp_close(loss, gamma, ref_loss, ref_gamma, il):
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    for b in range(gamma.shape[0]):
        g, r = gamma[b, : il[b]], np.asarray(ref_gamma)[b, : il[b]]
        fin = r > -1e29
        np.testing.assert_array_equal(g <= -1e29, ~fin)
        np.testing.assert_allclose(g[fin], r[fin], rtol=1e-6, atol=1e-4)
        assert np.all(gamma[b, il[b]:] == np.float32(P.NEG_INF))


CASES = {
    # b, t, v, l, input-length overrides, label-length overrides
    "repeats_padded": (4, 15, 6, 4, {}, {}),
    "len1_infeasible": (4, 12, 5, 3, {1: 1, 2: 2}, {1: 1, 2: 3}),
    "s_over_128": (2, 160, 30, 70, {1: 141}, {1: 66}),
    "len_above_t": (3, 14, 6, 4, {1: 19}, {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_kernels_and_scan(name):
    b, t, v, l, lo, lab = CASES[name]
    lp, labels, il, ll = _problem(len(name), b, t, v, l, lo, lab)
    loss, gamma = _port_dp(lp, labels, il, ll)
    llp, s_lens, allow2 = _jax_label_logp(lp, labels, ll)
    il_j = jnp.asarray(il)
    kernels = (J._ctc_pallas_batched, J._ctc_pallas) if il.max() <= t \
        else (J._ctc_pallas,)
    for kernel in kernels:
        ref_loss, ref_gamma = kernel(llp, il_j, s_lens, allow2,
                                     interpret=True)
        _assert_dp_close(loss, gamma, np.asarray(ref_loss), ref_gamma, il)
    scan_loss, alphas = J.ctc_forward_scan(llp, il_j, s_lens, allow2)
    betas = J.ctc_backward_scan(llp, il_j, s_lens, allow2)
    scan_gamma = alphas + betas + scan_loss[:, None, None]
    _assert_dp_close(loss, gamma, np.asarray(scan_loss), scan_gamma, il)


def test_loss_gradient_matches_jax_grad():
    lp, labels, il, ll = _problem(5, 4, 14, 7, 4, {1: 1, 2: 3}, {1: 1, 2: 3})

    def f(x):
        per = J.ctc_loss(x, jnp.asarray(il), jnp.asarray(labels),
                         jnp.asarray(ll), 0, False)
        return jnp.sum(per * jnp.asarray([1.0, 0.5, 0.0, 2.0]))

    jg = np.asarray(jax.grad(f)(jnp.asarray(lp)))
    x = torch.from_numpy(lp).requires_grad_()
    per = P.ctc_loss(x, torch.from_numpy(il), torch.from_numpy(labels).long(),
                     torch.from_numpy(ll))
    (per * torch.tensor([1.0, 0.5, 0.0, 2.0])).sum().backward()
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), jg, rtol=1e-4, atol=1e-4)
    assert np.all(x.grad.numpy()[1, 1:] == 0)   # past the input length


@pytest.mark.parametrize("impl,length_normalized", [
    ("optax", False), ("native", False), ("optax", True)])
def test_head_loss_and_grad_match_jax(impl, length_normalized):
    """Feasible, infeasible (masked to 0, finite gradient) and padded
    rows through both heads."""
    b, t, d, v = 4, 11, 16, 9
    rng = np.random.default_rng(11)
    hs = rng.standard_normal((b, t, d)).astype(np.float32)
    hlens = np.array([11, 9, 2, 6], np.int32)
    ys = rng.integers(1, v, (b, 5)).astype(np.int32)
    ys[1, 2] = ys[1, 1]
    ys_lens = np.array([5, 3, 4, 1], np.int32)
    ys[1, 3:] = -1
    ys[3, 1:] = -1
    fm = FlaxCTCHead(v, length_normalized, impl=impl)
    shapes = jax.eval_shape(fm.init, jax.random.PRNGKey(0), jnp.asarray(hs),
                            jnp.asarray(hlens), jnp.asarray(ys),
                            jnp.asarray(ys_lens))
    variables = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(_draw(rng, path[-1].key, leaf.shape)),
        shapes)

    def f(h):
        return fm.apply(variables, h, jnp.asarray(hlens), jnp.asarray(ys),
                        jnp.asarray(ys_lens))

    j_loss, j_grad = jax.value_and_grad(f)(jnp.asarray(hs))
    head = CTCHead(d, v, length_normalized_loss=length_normalized)
    head.load_state_dict(flax_to_state_dict(_flatten(variables), head))
    h = torch.from_numpy(hs).requires_grad_()
    loss = head.loss(h, torch.from_numpy(hlens), torch.from_numpy(ys),
                     torch.from_numpy(ys_lens))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    assert torch.isfinite(h.grad).all()
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(j_grad),
                               rtol=1e-4, atol=1e-4)


def test_dispatch_variant_at_the_flagship_shapes():
    # 10000-frame batch, ~8 s utterances, S = 49: 38.8 KB of history
    assert P.dispatch_variant(12, 198, 49) == "shared"
    # the 80k-frame TPU batch [256, 77, 49]: the batch does not enter
    assert P.dispatch_variant(256, 77, 49) == "shared"
    # 19.5 s with 120 tokens: T' = 486, S = 241, 468 KB of history
    assert P.dispatch_variant(2, 486, 241) == "global"
    # the JAX package's "large" shape
    assert P.dispatch_variant(8, 1024, 241) == "global"
    # the border: both [T, S] histories, 2 * T * S * 4 bytes, against
    # 227 KB less 1 KB; and K1 takes S <= 128 (4 positions a lane)
    assert P.dispatch_variant(1, 590, 49) == "shared"
    assert P.dispatch_variant(1, 591, 49) == "global"
    assert P.dispatch_variant(1, 10, 128) == "shared"
    assert P.dispatch_variant(1, 10, 129) == "global"
    with pytest.raises(ValueError):
        P.dispatch_variant(1, 10, 1025)


def test_cpu_tensor_never_reaches_a_kernel(monkeypatch):
    def no_build(*_):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(nvcc, "load_library", no_build)
    before = (P.ctc_dp_shared.launches, P.ctc_dp_global.launches)
    lp, labels, il, ll = _problem(1, 2, 8, 5, 2)
    _port_dp(lp, labels, il, ll)
    assert (P.ctc_dp_shared.launches, P.ctc_dp_global.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        P.ctc_dp_shared(torch.zeros(1, 4, 3), torch.ones(1), torch.ones(1),
                        torch.zeros(1, 3, dtype=torch.bool))


def test_kernel_source_and_python_share_their_constants():
    src = (nvcc.CSRC_DIR / P.SOURCE).read_text()
    for name in ("MAX_S", "K1_MAX_P", "K2_MAX_W", "K2_CHUNK",
                 "K2_MAX_SLOTS"):
        assert f"constexpr int {name} = {getattr(P, name)};" in src, name
    assert "constexpr int PAIR_MAX_S = 32 * K1_MAX_P;" in src
    assert P.PAIR_MAX_S == 32 * P.K1_MAX_P
    assert "static_assert(MAX_S <= 32 * 4 * K2_MAX_W," in src
    assert P.global_plan(P.MAX_S)[0] == 4
    assert "constexpr int K2_WARPS = K2_MAX_W + 1;" in src
    assert P.K2_WARPS == P.K2_MAX_W + 1
    assert f"constexpr int K2_RING_BYTES = {P.K2_RING_BYTES // 1024} * 1024;" \
        in src
    assert "constexpr float NEG_INF = -1.0e30f;" in src
    # openeat_ctc_dp_smem_bytes's two formulas and K2's plan, as
    # smem_bytes and global_plan mirror them
    assert "long long pair_smem(int t_len, int s_n) " \
        "{ return 2LL * t_len * s_n * 4; }" in src
    assert "return 4LL * global_slots(s_n) * K2_CHUNK * s_n;" in src
    assert "return min(K2_MAX_SLOTS, K2_RING_BYTES / (K2_CHUNK * s_n * 4));" \
        in src
    assert "  int p = 1;\n  while (32 * p * K2_MAX_W < s_n) p *= 2;" in src
    assert "out[1] = (s_n + 32 * p - 1) / (32 * p);" in src
    assert "out[3] = K2_WARPS * 32;" in src


@pytest.mark.parametrize("s", [3, 33, 49, 121, 128])
def test_dispatch_variant_and_smem_budget_agree_at_the_border(s):
    """K1 is picked exactly up to the largest T whose shared memory fits
    the budget, whatever the batch."""
    t_max = P.SMEM_BUDGET // (2 * s * 4)
    assert P.smem_bytes(t_max, s, "shared") <= P.SMEM_BUDGET \
        < P.smem_bytes(t_max + 1, s, "shared")
    for b in (1, 256):
        assert P.dispatch_variant(b, t_max, s) == "shared"
        assert P.dispatch_variant(b, t_max + 1, s) == "global"
    slots = P.global_plan(s)[2]
    assert P.smem_bytes(10_000, s, "global") == 4 * slots * P.K2_CHUNK * s


def _shfl(v, d):
    """__shfl_up_sync (d > 0) or __shfl_down_sync (d < 0) across 32
    lanes: lane l gets lane l - d's value, or its own where that lane
    does not exist."""
    src = torch.arange(32) - d
    src = torch.where((src >= 0) & (src < 32), src, torch.arange(32))
    return v[src]


def _k1_walk(label_logp, input_lens, s_lens, allow2, per):
    """The K1 kernel's lane layout in torch: lane l owns positions
    l * per + q, alpha takes s-1 and s-2 it does not own from lane l-1,
    beta takes s+1 and s+2 from lane l+1, by shuffles; the same lae3 as
    the plain recursions. Returns (loss, gamma) as the kernel writes
    them."""
    b_, t_, s_ = label_logp.shape
    neg = P.NEG_INF
    pos = torch.arange(32)[:, None] * per + torch.arange(per)[None, :]
    on = pos < s_
    pc = pos.clamp(max=s_ - 1)
    loss = torch.empty(b_)
    gamma = torch.full((b_, t_, s_), neg)
    full = torch.full((32, per), neg)

    def own(v, q):
        return v[:, q] if 0 <= q < per else None

    for b in range(b_):
        lp = label_logp[b]
        n = max(0, min(int(input_lens[b]), t_))
        slen = int(s_lens[b])
        end1, end2 = slen - 1, max(slen - 2, 0)
        a2 = allow2[b]
        skip_in = on & (pos >= 2) & a2[pc]
        skip_out = on & (pos + 2 < s_) & a2[(pos + 2).clamp(max=s_ - 1)]
        ends = [torch.tensor(neg), torch.tensor(neg)]
        ahist = torch.full((t_, s_), neg)
        bhist = torch.full((t_, s_), neg)
        if n >= 1:
            alpha = torch.where(on & (pos < 2) & (pos < slen), lp[0][pc],
                                full)
            ahist[0] = alpha.flatten()[:s_]
            for t in range(1, n):
                up1 = _shfl(alpha[:, per - 1], 1)
                up2 = _shfl(alpha[:, per - 2], 1) if per > 1 \
                    else _shfl(alpha[:, 0], 2)
                a1 = torch.stack([own(alpha, q - 1) if q >= 1 else up1
                                  for q in range(per)], 1)
                a1 = torch.where(pos < 1, full, a1)
                a2v = torch.stack([own(alpha, q - 2) if q >= 2 else
                                   (up1 if q == 1 else up2)
                                   for q in range(per)], 1)
                a2v = torch.where(skip_in, a2v, full)
                alpha = torch.where(on, P._lae3(alpha, a1, a2v) + lp[t][pc],
                                    full)
                ahist[t] = alpha.flatten()[:s_]
            flat = alpha.flatten()
            ends[0] = flat[end1]
            if end2 != end1:
                ends[1] = flat[end2]
            beta = torch.where(on & ((pos == end1) | (pos == end2)), 0.0,
                               full)
            bhist[n - 1] = beta.flatten()[:s_]
            for i in range(n - 2, -1, -1):
                bn0 = torch.where(on, beta + lp[i + 1][pc], full)
                dn1 = _shfl(bn0[:, 0], -1)
                dn2 = _shfl(bn0[:, 1], -1) if per > 1 else _shfl(bn0[:, 0], -2)
                b1 = torch.stack([own(bn0, q + 1) if q + 1 < per else dn1
                                  for q in range(per)], 1)
                b1 = torch.where(pos + 1 >= s_, full, b1)
                b2 = torch.stack([own(bn0, q + 2) if q + 2 < per else
                                  (dn1 if q + 2 == per else dn2)
                                  for q in range(per)], 1)
                b2 = torch.where(skip_out, b2, full)
                beta = torch.where(on, P._lae3(bn0, b1, b2), full)
                bhist[i] = beta.flatten()[:s_]
        logz = P._lae3(ends[0], ends[1], torch.tensor(neg))
        loss[b] = -logz
        gamma[b, :n] = ahist[:n] + bhist[:n] - logz
    return loss, gamma


@pytest.mark.parametrize("b,t,v,l,lo,lab", [
    (4, 12, 5, 3, {1: 1, 2: 2}, {1: 1, 2: 3}),   # S = 7: one position a lane
    (3, 20, 9, 15, {1: 1}, {2: 15}),             # S = 31
    (3, 25, 12, 16, {2: 7}, {1: 2}),             # S = 33: two a lane
    (2, 30, 40, 24, {}, {1: 20}),                # S = 49
    (2, 40, 80, 60, {1: 33}, {1: 60}),           # S = 121: four a lane
])
def test_k1_lane_layout_walk_is_the_plain_recursion(b, t, v, l, lo, lab):
    lp, labels, il, ll = _problem(b * 1000 + t, b, t, v, l, lo, lab)
    z, s_lens = P.extended_labels(torch.from_numpy(labels),
                                  torch.from_numpy(ll))
    allow2 = P.transition_masks(z)
    llp = P.gather_label_logp(torch.from_numpy(lp), z)
    s = llp.shape[2]
    per = -(-s // 32)
    assert per <= P.K1_MAX_P and P.dispatch_variant(b, t, s) == "shared"
    loss, gamma = _k1_walk(llp, torch.from_numpy(il), s_lens, allow2, per)
    ref_loss, ref_gamma = P.ctc_dp_plain(llp, torch.from_numpy(il), s_lens,
                                         allow2)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-6, atol=1e-5)
    dead = ref_gamma <= -1e29
    assert torch.equal(gamma <= -1e29, dead)
    torch.testing.assert_close(gamma[~dead], ref_gamma[~dead], rtol=1e-6,
                               atol=1e-4)


def test_k2_plan_at_the_flagship_and_extreme_widths():
    """global_plan: the fewest positions a lane from 1 up with which at
    most K2_MAX_W warps cover S; ring slots by the ring budget; the two
    rings fit the block's shared memory at every S up to MAX_S."""
    # S = 49 (a tall K2 batch), S = 241 (the flagship's long batch),
    # S = 1001 and MAX_S
    assert P.global_plan(49) == (1, 2, 8, 32 * P.K2_WARPS)
    assert P.global_plan(241) == (1, 8, 8, 32 * P.K2_WARPS)
    assert P.global_plan(257) == (2, 5, 8, 32 * P.K2_WARPS)
    assert P.global_plan(1001) == (4, 8, 3, 32 * P.K2_WARPS)
    assert P.global_plan(P.MAX_S) == (4, 8, 3, 32 * P.K2_WARPS)
    assert P.K2_WARPS * 32 <= 1024
    for s in range(1, P.MAX_S + 1):
        p, w, slots, _ = P.global_plan(s)
        assert w <= P.K2_MAX_W and (p == 1 or 32 * (p // 2) * 8 < s)
        assert p in (1, 2, 4)         # the kernel's instances
        assert slots >= 2
        assert P.smem_bytes(1, s, "global") <= P.SMEM_BUDGET


class _Ring:
    """K2's label_logp ring (csrc/ctc_loss.cu, struct Ring) in torch: the
    producer fills chunk c into slot c % slots once the consumer has freed
    it, and the consumer's cursor walks slots and barrier parities as the
    kernel's does. Checks every barrier phase the kernel would wait on."""

    def __init__(self, lp, n, slots, backward):
        self.lp, self.n, self.slots, self.dir = lp, n, slots, int(backward)
        self.s = lp.shape[1]
        self.buf = torch.full((slots, P.K2_CHUNK * self.s), float("nan"))
        self.fills = [0] * slots      # completed phases of each full barrier
        self.frees = [0] * slots      # completed phases of each empty one
        self.filled = 0               # chunks the producer has filled
        self.items = max(self.n - 1, 0) if backward else self.n
        self.chunks = -(-self.items // P.K2_CHUNK)
        # the cursor
        self.c, self.left, self.slot, self.parity = -1, 0, slots - 1, 1
        self.row = None

    def _lo(self, c):
        return max(1, self.n - (c + 1) * P.K2_CHUNK) if self.dir \
            else c * P.K2_CHUNK

    def _frames(self, c):
        return self.n - c * P.K2_CHUNK - self._lo(c) if self.dir \
            else min(P.K2_CHUNK, self.n - c * P.K2_CHUNK)

    def _produce(self):
        while self.filled < self.chunks:
            c = self.filled
            slot = c % self.slots
            if c >= self.slots:
                # the producer waits on parity ((c / slots) + 1) & 1
                if self.frees[slot] < c // self.slots:
                    return
                assert (self.frees[slot] - 1) % 2 == (c // self.slots + 1) % 2
            rows = self.lp[self._lo(c): self._lo(c) + self._frames(c)]
            self.buf[slot].fill_(float("nan"))
            self.buf[slot, : rows.numel()] = rows.reshape(-1)
            self.fills[slot] += 1
            self.filled += 1

    def next(self):
        """The next item's row, as Ring::next gives it."""
        if self.left == 0:
            self.c += 1
            prev = self.slot
            self.slot += 1
            if self.slot == self.slots:
                self.slot, self.parity = 0, self.parity ^ 1
            self._produce()
            # the consumer waits on parity `parity` of full[slot]
            assert self.fills[self.slot] == self.c // self.slots + 1
            assert (self.fills[self.slot] - 1) % 2 == self.parity
            if self.c > 0:
                self.frees[prev] += 1
            self.left = self._frames(self.c) - 1
            self.row = (self.slot * P.K2_CHUNK
                        + (self.left if self.dir else 0)) * self.s
        else:
            self.left -= 1
            self.row += -self.s if self.dir else self.s
        return self.buf.reshape(-1)[self.row: self.row + self.s]


def _k2_walk(label_logp, input_lens, s_lens, allow2, per=None):
    """The K2 kernel's layout in torch: W warps x 32 lanes x P positions
    a recursion (global_plan, or P = `per`), neighbours by shuffles inside
    a warp and through the step-parity edge slots between warps, label_logp
    through the two rings, alpha's rows stored into gamma and beta's into
    the workspace, then the gamma pass, split between the cluster's two
    blocks. Returns (loss, gamma)."""
    b_, t_, s_ = label_logp.shape
    p, w, slots, _ = P.global_plan(s_)
    if per is not None:
        p, w = per, -(-s_ // (32 * per))
    assert w <= P.K2_MAX_W
    neg = P.NEG_INF
    k_of = torch.arange(w)[:, None, None]
    lane = torch.arange(32)[None, :, None]
    pos = (k_of * 32 + lane) * p + torch.arange(p)[None, None, :]
    on = pos < s_
    pc = pos.clamp(max=s_ - 1)
    full = torch.full((w, 32, p), neg)
    lanes = torch.arange(32)
    loss = torch.empty(b_)
    gamma = torch.empty((b_, t_, s_))

    def shfl(v, d):
        """__shfl_up_sync (d > 0) / __shfl_down_sync (d < 0) in each warp."""
        src = lanes - d
        src = torch.where((src >= 0) & (src < 32), src, lanes)
        return v[:, src]

    def take(e, frm, both, second, x, y):
        ev = e[frm]                                   # [w, 2]
        x2 = torch.where(both, ev[:, 0:1], x)
        y2 = torch.where(both, ev[:, 1:2],
                         torch.where(second, ev[:, 0:1], y))
        return x2, y2

    ks = torch.arange(w)
    for b in range(b_):
        lp = label_logp[b]
        n = max(0, min(int(input_lens[b]), t_))
        slen = int(s_lens[b])
        end1, end2 = slen - 1, max(slen - 2, 0)
        a2 = allow2[b]
        skip_in = on & (pos >= 2) & a2[pc]
        skip_out = on & (pos + 2 < s_) & a2[(pos + 2).clamp(max=s_ - 1)]
        ga = torch.full((t_, s_), float("nan"))
        gb = torch.full((t_, s_), float("nan"))
        ends = [torch.tensor(neg), torch.tensor(neg)]
        # the lanes that take the edge pair, and from which warp
        a_from = (ks - 1).clamp(min=0)
        b_from = (ks + 1).clamp(max=w - 1)
        a_take = (w > 1) & (a_from != ks)[:, None]
        b_take = (w > 1) & (b_from != ks)[:, None]
        a_both, a_second = a_take & (lanes == 0), a_take & (p == 1) & (lanes == 1)
        b_both = b_take & (lanes == 31)
        b_second = b_take & (p == 1) & (lanes == 30)

        def store(hist, t, v):
            hist[t] = v.reshape(-1)[:s_]

        if n >= 1:
            # ---- alpha
            ring = _Ring(lp, n, slots, backward=False)
            edge = torch.full((2, w, 2), float("nan"))
            row0 = ring.next()
            alpha = torch.where(on & (pos < 2) & (pos < slen), row0[pc], full)
            store(ga, 0, alpha)
            lp_t = torch.where(on, ring.next()[pc], 0.0) if n > 1 else None

            def hand_on_a(par, v):
                edge[par, :, 0] = v[:, 31, p - 1]
                edge[par, :, 1] = v[:, 31, p - 2] if p > 1 else v[:, 30, 0]

            if w > 1:
                hand_on_a(0, alpha)
            for t in range(1, n):
                up1 = shfl(alpha[:, :, p - 1], 1)
                up2 = shfl(alpha[:, :, p - 2], 1) if p > 1 \
                    else shfl(alpha[:, :, 0], 2)
                up1, up2 = take(edge[(t - 1) & 1], a_from, a_both, a_second,
                                up1, up2)
                a1 = torch.stack([alpha[:, :, q - 1] if q >= 1 else up1
                                  for q in range(p)], 2)
                a1 = torch.where(pos < 1, full, a1)
                a2v = torch.stack([alpha[:, :, q - 2] if q >= 2 else
                                   (up1 if q == 1 else up2)
                                   for q in range(p)], 2)
                a2v = torch.where(skip_in, a2v, full)
                alpha = torch.where(on, P._lae3(alpha, a1, a2v) + lp_t, full)
                if w > 1:
                    hand_on_a(t & 1, alpha)
                store(ga, t, alpha)
                if t + 1 < n:
                    lp_t = torch.where(on, ring.next()[pc], 0.0)
            flat = alpha.reshape(-1)
            ends[0] = flat[end1]
            if end2 != end1:
                ends[1] = flat[end2]
            assert ring.filled == ring.chunks and ring.c == ring.chunks - 1
            # ---- beta
            ring = _Ring(lp, n, slots, backward=True)
            edge = torch.full((2, w, 2), float("nan"))

            def hand_on_b(par, v):
                edge[par, :, 0] = v[:, 0, 0]
                edge[par, :, 1] = v[:, 0, 1] if p > 1 else v[:, 1, 0]

            beta = torch.where(on & ((pos == end1) | (pos == end2)), 0.0,
                               full)
            store(gb, n - 1, beta)
            if n > 1:
                bn0 = torch.where(on, beta + ring.next()[pc], full)
                lp_i = torch.where(on, ring.next()[pc], 0.0) if n > 2 \
                    else None
                if w > 1:
                    hand_on_b(0, bn0)
            parity = 0
            for i in range(n - 2, -1, -1):
                dn1 = shfl(bn0[:, :, 0], -1)
                dn2 = shfl(bn0[:, :, 1], -1) if p > 1 \
                    else shfl(bn0[:, :, 0], -2)
                dn1, dn2 = take(edge[parity], b_from, b_both, b_second, dn1,
                                dn2)
                b1 = torch.stack([bn0[:, :, q + 1] if q + 1 < p else dn1
                                  for q in range(p)], 2)
                b1 = torch.where(pos + 1 >= s_, full, b1)
                b2 = torch.stack([bn0[:, :, q + 2] if q + 2 < p else
                                  (dn1 if q + 2 == p else dn2)
                                  for q in range(p)], 2)
                b2 = torch.where(skip_out, b2, full)
                beta = torch.where(on, P._lae3(bn0, b1, b2), full)
                if i >= 1:
                    bn0 = torch.where(on, beta + lp_i, full)
                    parity ^= 1
                    if w > 1:
                        hand_on_b(parity, bn0)
                store(gb, i, beta)
                if i >= 2:
                    lp_i = torch.where(on, ring.next()[pc], 0.0)
            assert ring.filled == ring.chunks and ring.c == ring.chunks - 1
        # both recursions stored every walked row, and only those
        assert not torch.isnan(ga[:n]).any() and torch.isnan(ga[n:]).all()
        assert not torch.isnan(gb[:n]).any() and torch.isnan(gb[n:]).all()
        loss[b] = -P._lae3(ends[0], ends[1], torch.tensor(neg))
        logz = -loss[b]          # beta's block reads the loss alpha's wrote
        # gamma_range over each block's half of the elements
        plane = t_ * s_
        mid = (plane // 2) & ~3
        out = torch.full((plane,), float("nan"))
        for lo, hi in ((0, mid), (mid, plane)):
            idx = torch.arange(lo, hi)
            flat = ((ga + gb) - logz).reshape(-1)
            assert torch.isnan(out[idx]).all()       # each element once
            out[idx] = torch.where(idx < n * s_, flat[idx], neg)
        assert not torch.isnan(out).any()
        gamma[b] = out.reshape(t_, s_)
    return loss, gamma


@pytest.mark.parametrize("b,t,v,l,lo,lab,per", [
    # S = 49, T tall enough that only K2 takes it: the plan's W = 2 of
    # P = 1, and one warp of P = 2 (K1's step); len 1, len 0, above T
    (3, 600, 40, 24, {1: 1, 2: 605}, {1: 20}, None),
    (3, 600, 40, 24, {1: 0, 2: 17}, {2: 24}, 2),
    # S = 241, the flagship's long batch: the plan's 8 warps of P = 1,
    # and the kernel's other instances there (4 warps of P = 2, 2 of 4);
    # repeats, an infeasible row (more labels than frames), above T
    (4, 70, 200, 120, {1: 1, 2: 40, 3: 75}, {2: 120}, None),
    (4, 70, 200, 120, {1: 1, 2: 40, 3: 75}, {2: 120}, 2),
    (2, 45, 200, 120, {1: 50}, {}, 4),
    # S = 301: the plan's 5 warps of P = 2
    (2, 160, 300, 150, {1: 3}, {1: 1}, None),
    # S = 1001: 8 warps of P = 4, 3 ring slots; row 0 feasible
    (2, 510, 900, 500, {1: 300}, {1: 140}, None),
])
def test_k2_layout_walk_is_the_plain_recursion(b, t, v, l, lo, lab, per):
    lp, labels, il, ll = _problem(b * 1000 + t + (per or 0), b, t, v, l, lo,
                                  lab)
    labels[0, 2] = labels[0, 1]                      # a second repeat
    z, s_lens = P.extended_labels(torch.from_numpy(labels),
                                  torch.from_numpy(ll))
    allow2 = P.transition_masks(z)
    llp = P.gather_label_logp(torch.from_numpy(lp), z)
    s = llp.shape[2]
    assert P.dispatch_variant(b, t, s) == "global"
    loss, gamma = _k2_walk(llp, torch.from_numpy(il), s_lens, allow2, per)
    ref_loss, ref_gamma = P.ctc_dp_plain(llp, torch.from_numpy(il), s_lens,
                                         allow2)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-6, atol=1e-5)
    dead = ref_gamma <= -1e29
    assert torch.equal(gamma <= -1e29, dead)
    torch.testing.assert_close(gamma[~dead], ref_gamma[~dead], rtol=1e-6,
                               atol=1e-4)
    if l + 2 <= t:
        assert float(loss[0]) < 1e29                 # a feasible row
