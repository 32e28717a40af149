"""openeat_torch CTC (kernels K1/K2) on the CPU.

The CUDA kernels run only on a card (chip_smoke.py holds them against
the plain version there). Here the plain version, which the CPU route of
the autograd Function runs, is held against the JAX package:
- loss within 1e-5 relative and gamma within 1e-4 absolute plus 1e-6
  relative on finite entries (a float32 sum of T terms: gamma reaches
  -300 at T=160, where one ulp is 3e-5), NEG_INF entries equal, against
  the two Pallas kernels in interpret mode and against the scan oracles,
  over repeats, len == 1, infeasible rows, a padded batch and S > 128;
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
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_kernels_and_scan(name):
    b, t, v, l, lo, lab = CASES[name]
    lp, labels, il, ll = _problem(len(name), b, t, v, l, lo, lab)
    loss, gamma = _port_dp(lp, labels, il, ll)
    llp, s_lens, allow2 = _jax_label_logp(lp, labels, ll)
    il_j = jnp.asarray(il)
    for kernel in (J._ctc_pallas_batched, J._ctc_pallas):
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
    for name in ("MAX_S", "K1_MAX_P"):
        assert f"constexpr int {name} = {getattr(P, name)};" in src, name
    assert "constexpr int PAIR_MAX_S = 32 * K1_MAX_P;" in src
    assert P.PAIR_MAX_S == 32 * P.K1_MAX_P
    assert "constexpr float NEG_INF = -1.0e30f;" in src
    # openeat_ctc_dp_smem_bytes's two formulas, as smem_bytes mirrors them
    assert "long long pair_smem(int t_len, int s_n) " \
        "{ return 2LL * t_len * s_n * 4; }" in src
    assert "long long global_smem(int s_n) { return 2LL * s_n * 4; }" in src


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
    assert P.smem_bytes(10_000, s, "global") == 2 * s * 4


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
