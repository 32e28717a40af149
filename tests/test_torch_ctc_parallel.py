"""`ctc_impl: parallel` on the port against the JAX package.

Logits, labels and lengths from seeded numpy, with a repeated label, a
one-frame utterance, padded frames and padded labels. The port's
ctc_loss_parallel against JAX's on the feasible rows (losses within
1e-5 relative, gradients within 1e-4 of the largest |grad|: the same
product, associated in another order) and against the port's K1/K2
op's plain version (the same tolerance); CTCHead(impl="parallel") against
the JAX head with ctc_impl parallel (the loss within 1e-5 relative) and
against the port's default head (the loss, and the gradients of its
input and projection within 1e-4 of the largest). A model built from a
model_conf with ctc_impl: parallel runs it. Where the JAX module's
float32 product underflows it invents a path (its 1e-30 clamp); the
port's float64 product does not, and on a long input equals the K1/K2
op. The JAX scan's gradient is traced once: it takes most of this
file's time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from openeat_torch.modules import ctc as ctc_module
from openeat_torch.modules.ctc import CTCHead
from openeat_torch.ops import ctc_loss as ctc_op
from openeat_torch.ops import ctc_parallel
from openeat_torch.ops.ctc_parallel import ctc_loss_parallel
from openeat_torch.utils.param_bridge import flax_to_state_dict
from openeat_tpu.modules.ctc import CTCHead as JaxCTCHead
from openeat_tpu.ops import ctc_parallel as jax_ctc_parallel
from openeat_tpu.ops.ctc_parallel import ctc_loss_parallel as jax_parallel
from openeat_tpu.utils.checkpoint import _flatten
from tests._torch_parity import TINY_CONF, tiny_models

torch.set_num_threads(1)


def _case(seed=1, b=6, t=30, v=12, l=7):
    """Row 0: a repeated label, every frame and label; row 1: padded
    frames and labels; row 2: one frame (infeasible); row 3: one label;
    the rest random lengths."""
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((b, t, v))).astype(np.float32)
    labels = rng.integers(1, v, (b, l)).astype(np.int64)
    labels[0, 1] = labels[0, 0]
    t_lens = rng.integers(t // 2, t + 1, b)
    l_lens = rng.integers(2, l + 1, b)
    t_lens[0], l_lens[0] = t, l
    t_lens[1], l_lens[1] = t - 7, l - 3
    t_lens[2] = 1
    l_lens[3] = 1
    tpad = (np.arange(t)[None] >= t_lens[:, None]).astype(np.float32)
    lpad = (np.arange(l)[None] >= l_lens[:, None]).astype(np.float32)
    return logits, tpad, labels, lpad, t_lens, l_lens


def test_loss_and_gradient_equal_jax():
    """Feasible rows: losses and the gradient of their sum equal JAX's.
    The one-frame row cannot hold its labels: the port gives it the
    semiring zero (-NEG), JAX a finite value of its clamped product; the
    CTC head zeroes such a row either way."""
    logits, tpad, labels, lpad, t_lens, l_lens = _case()
    feasible = t_lens >= l_lens + 1
    assert not feasible[2] and feasible.sum() == len(feasible) - 1
    mask = feasible.astype(np.float32)
    args = (jnp.asarray(tpad), jnp.asarray(labels.astype(np.int32)),
            jnp.asarray(lpad))
    want = np.asarray(jax_parallel(jnp.asarray(logits), *args))
    want_grad = np.asarray(jax.grad(
        lambda z: jnp.sum(jax_parallel(z, *args) * mask))(
            jnp.asarray(logits)))
    x = torch.tensor(logits, requires_grad=True)
    got = ctc_loss_parallel(x, torch.from_numpy(tpad),
                            torch.from_numpy(labels), torch.from_numpy(lpad))
    (got * torch.from_numpy(mask)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy()[feasible],
                               want[feasible], rtol=1e-5)
    assert float(got[2].detach()) >= -ctc_parallel.NEG / 2 and want[2] < 1e3
    g_max = np.abs(want_grad).max()
    assert np.abs(x.grad.numpy() - want_grad).max() <= 1e-4 * g_max
    # the port's K1/K2 op (its plain version here) on the feasible rows
    x2 = torch.tensor(logits, requires_grad=True)
    ref = ctc_op.ctc_loss(torch.log_softmax(x2, dim=-1),
                          torch.from_numpy(t_lens), torch.from_numpy(labels),
                          torch.from_numpy(l_lens))
    ref[torch.from_numpy(feasible)].sum().backward()
    np.testing.assert_allclose(got.detach().numpy()[feasible],
                               ref.detach().numpy()[feasible], rtol=1e-5)
    assert np.abs(x.grad.numpy() - x2.grad.numpy()).max() <= 1e-4 * g_max


def test_ctc_head_parallel_equals_jax_head():
    """The JAX head's loss (ctc_impl parallel), and the port's parallel
    head's gradients against its default head's (whose op the test
    above and tests/test_torch_ctc.py hold to JAX)."""
    b, t, d, v, l = 3, 26, 8, 12, 5
    rng = np.random.default_rng(4)
    hs = rng.standard_normal((b, t, d)).astype(np.float32)
    hlens = np.array([26, 20, 15], np.int32)
    ys = rng.integers(1, v, (b, l)).astype(np.int32)
    ys_lens = np.array([5, 3, 2], np.int32)
    jhead = JaxCTCHead(v, impl="parallel")
    jargs = (jnp.asarray(hs), jnp.asarray(hlens), jnp.asarray(ys),
             jnp.asarray(ys_lens))
    params = jhead.init(jax.random.PRNGKey(0), *jargs)
    want = float(jhead.apply(params, *jargs))
    heads = {}
    for impl in ("parallel", "optax"):
        head = CTCHead(d, v, impl=impl)
        head.load_state_dict(flax_to_state_dict(_flatten(params), head))
        x = torch.tensor(hs, requires_grad=True)
        loss = head.loss(x, torch.from_numpy(hlens).long(),
                         torch.from_numpy(ys).long(),
                         torch.from_numpy(ys_lens).long())
        loss.backward()
        heads[impl] = (float(loss.detach()), x.grad.numpy(),
                       head.ctc_lo.weight.grad.numpy())
    np.testing.assert_allclose(heads["parallel"][0], want, rtol=1e-5)
    np.testing.assert_allclose(heads["optax"][0], want, rtol=1e-5)
    for i in (1, 2):
        ref = heads["optax"][i]
        assert np.abs(heads["parallel"][i] - ref).max() \
            <= 1e-4 * np.abs(ref).max()


def test_model_conf_ctc_impl_selects_the_op(monkeypatch):
    _, _, _, tm = tiny_models(0, ctc_impl="parallel", dropout_rate=0.0)
    assert tm.ctc.impl == "parallel"
    _, _, _, default = tiny_models(0, dropout_rate=0.0)
    assert default.ctc.impl == TINY_CONF.get("ctc_impl", "optax")
    calls = []
    real = ctc_module.ctc_loss_parallel
    monkeypatch.setattr(ctc_module, "ctc_loss_parallel",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(2)
    feats = torch.from_numpy(rng.standard_normal((2, 60, 80)).astype(
        np.float32))
    lens = torch.tensor([60, 45])
    ys = torch.tensor([[3, 4, 5], [6, 7, -1]])
    ys_lens = torch.tensor([3, 2])
    with torch.no_grad():
        got = tm.train()(feats, lens, ys, ys_lens)["loss_ctc"]
        want = default.train()(feats, lens, ys, ys_lens)["loss_ctc"]
    assert calls == [1]
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_jax_log_matmul_invents_a_path_where_its_product_underflows():
    """LSE over k of a[i, k] + b[k, j] with a = [0, -100] and b = [-100,
    0]: every term is -100 (the LSE -100 + log 2), but the row's and the
    column's maxima sit at different k. The JAX module's float32 product
    underflows and its 1e-30 clamp gives -69.08; the port's float64
    product gives the value."""
    a = np.array([[[0.0, -100.0]]], np.float32)
    b = np.array([[[-100.0], [0.0]]], np.float32)
    want = -100.0 + np.log(2.0)
    got = float(ctc_parallel._log_matmul(torch.from_numpy(a),
                                         torch.from_numpy(b)))
    jax_got = float(np.asarray(jax_ctc_parallel._log_matmul(
        jnp.asarray(a), jnp.asarray(b))).ravel()[0])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(jax_got, np.log(1e-30), rtol=1e-5)


def test_long_input_equals_the_k1_k2_op():
    """A seeded T = 300, L = 20, V = 400 utterance, where JAX's clamped
    product loses 1.3 % of the loss: the port's loss within 1e-5
    relative of the K1/K2 op's plain version and its gradient within
    1e-2 of the largest |grad| (the op's float32 recursions at |log p| of
    a few thousand are the looser of the two)."""
    t, l, v = 300, 20, 400
    logits = torch.randn(1, t, v, generator=torch.Generator().manual_seed(t))
    labels = torch.randint(1, v, (1, l),
                           generator=torch.Generator().manual_seed(l))
    x = logits.clone().requires_grad_()
    got = ctc_loss_parallel(x, torch.zeros(1, t), labels, torch.zeros(1, l))
    got.sum().backward()
    x2 = logits.clone().requires_grad_()
    ref = ctc_op.ctc_loss(torch.log_softmax(x2, dim=-1), torch.tensor([t]),
                          labels, torch.tensor([l]))
    ref.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-5)
    g_max = float(x2.grad.abs().max())
    assert float((x.grad - x2.grad).abs().max()) <= 1e-2 * g_max
