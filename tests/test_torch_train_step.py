"""openeat_torch training step against the JAX package, on the CPU.

The tiny Conformer of tests/_torch_parity.py (2 blocks, d=64, 1+1
decoders, reverse_weight 0.3, ctc_weight 0.3, lsm 0.1) with dropout 0,
float32 on both sides:
- loss, loss_ctc, loss_att and acc against the JAX model's apply, with
  the JAX head's CTC as optax (the flagship's) and as its own kernel
  function, within 1e-5 relative;
- every parameter's gradient against jax.grad, mapped into torch layout
  through the weight bridge: max abs error within 1e-4 of that tensor's
  max |grad| (summation order over a few thousand terms) plus 1e-7 of the
  model's largest gradient. The second term covers the attention key
  biases, whose gradient is zero by the softmax's shift invariance and
  so is rounding noise (about 1e-9) in both frameworks;
- three steps of build_train_step with build_optimizer (WarmupLR, clip
  5) on both sides: a normal batch, a NaN batch that both skip (no
  update, the optimizer untouched, the step still counted, so the next
  update's learning rate is schedule(1)), and an accum_grad 2 step.
  With SGD the parameters match within 1e-6, which pins the clip scale
  and the learning rate. Adam divides each gradient by its own
  magnitude, which hides the clip scale and turns a rounding difference
  in a near-zero gradient into a step of up to lr: every parameter is
  held within 2 lr, and the elements whose first gradient is at least
  1e-3 of their tensor's largest and 1e-7 of the model's (not rounding
  noise, as the key biases' is) within lr / 100;
- label smoothing, SpecAugment and spec-substitute with the spans that
  JAX drew handed to the port;
- dropout's keep rate and scale, checked statistically, and its
  reproducibility from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openeat_tpu.modules.label_smoothing import \
    label_smoothing_loss as jax_lsm
from openeat_tpu.ops import specaug as jspec
from openeat_tpu.parallel.train_step import TrainState as JaxTrainState
from openeat_tpu.parallel.train_step import \
    build_train_step as jax_build_train_step
from openeat_tpu.utils.checkpoint import _flatten
from openeat_tpu.utils.optim import build_optimizer as jax_build_optimizer
from openeat_torch.modules.dropout import Dropout, set_generator
from openeat_torch.modules.label_smoothing import label_smoothing_loss
from openeat_torch.ops import specaug
from openeat_torch.parallel.train_step import (TrainState, build_eval_step,
                                               build_train_step)
from openeat_torch.utils.common import make_generator
from openeat_torch.utils.optim import build_optimizer
from openeat_torch.utils.param_bridge import flax_to_state_dict
from tests._torch_parity import FEAT_DIM, VOCAB, tiny_models

torch.set_num_threads(1)
NO_DROPOUT = dict(dropout_rate=0.0)


def _batch(seed=1, b=3, t=57):
    """Features, lengths and targets; row 2 has more labels than frames
    after subsampling (infeasible for CTC), row 0 a repeated label."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, t, FEAT_DIM)).astype(np.float32)
    lens = np.array([t, t - 16, 23][:b], np.int32)
    ys = rng.integers(1, VOCAB - 1, (b, 8)).astype(np.int32)
    ys[0, 2] = ys[0, 1]
    ys_lens = np.array([8, 3, 6][:b], np.int32)
    for i, n in enumerate(ys_lens):
        ys[i, n:] = -1
    return {"features": feats, "features_length": lens, "targets": ys,
            "targets_length": ys_lens}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("ctc_impl", ["optax", "native"])
def test_loss_and_every_gradient_match_jax(ctc_impl):
    jm, variables, _, tm = tiny_models(0, ctc_impl=ctc_impl, **NO_DROPOUT)
    batch = _batch()

    def loss_fn(v):
        m = jm.apply(v, *_jax_batch(batch).values())
        return m["loss"], m

    (_, j_metrics), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables)
    tm.train()
    metrics = tm(*_torch_batch(batch).values())
    metrics["loss"].backward()
    for key in ("loss", "loss_ctc", "loss_att", "acc"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(j_metrics[key]), rtol=1e-5,
                                   err_msg=key)
    want = flax_to_state_dict(_flatten(j_grads), tm)
    g_max = max(float(g.abs().max()) for g in want.values())
    for name, p in tm.named_parameters():
        ref = want[name].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max() + 1e-7 * g_max, (name, err)


def test_eval_step_is_the_deterministic_forward():
    jm, variables, _, tm = tiny_models(0)   # dropout 0.1, off in eval
    batch = _batch(seed=4)
    j = jm.apply(variables, *_jax_batch(batch).values(), deterministic=True)
    got = build_eval_step(tm)(_torch_batch(batch))
    assert not tm.training
    np.testing.assert_allclose(float(got["loss"]), float(j["loss"]),
                               rtol=1e-5)


def _params(tm):
    return {n: p.detach().numpy().copy() for n, p in tm.named_parameters()}


def _assert_params_close(got, want, optim, lr, first_grad):
    g_max = max(np.abs(g).max() for g in first_grad.values())
    for name in got:
        diff = np.abs(got[name] - want[name])
        if optim == "sgd":
            assert diff.max() <= 1e-6 * (1 + np.abs(want[name]).max()), name
            continue
        assert diff.max() <= 2 * lr, (name, diff.max())
        g = np.abs(first_grad[name])
        sure = (g >= 1e-3 * g.max()) & (g >= 1e-7 * g_max)
        if sure.any():
            assert diff[sure].max() <= lr / 100, (name, diff[sure].max())


@pytest.mark.parametrize("optim", ["adam", "sgd"])
def test_three_optimizer_steps_match_optax(optim):
    jm, variables, _, tm = tiny_models(0, **NO_DROPOUT)
    lr, warmup = 1e-3, 3
    tx, j_schedule = jax_build_optimizer(lr, warmup, optim, variables)
    j_state = JaxTrainState(variables, tx.init(variables),
                            jnp.zeros((), jnp.int32))
    j_steps = {a: jax.jit(jax_build_train_step(jm, tx, a, 5.0,
                                               donate=False))
               for a in (1, 2)}
    opt, schedule = build_optimizer(tm, lr, warmup, optim)
    state = TrainState(tm, opt)
    steps = {a: build_train_step(schedule, a, 5.0) for a in (1, 2)}
    for s in range(5):
        assert schedule(s) == pytest.approx(float(j_schedule(s)), rel=1e-6)

    good = _batch(seed=2)
    nan = _batch(seed=3)
    nan["features"][1, 5, 7] = np.nan
    accum = {k: np.stack([v[:2], _batch(seed=5)[k][:2]])
             for k, v in _batch(seed=6).items()}
    first_grad = flax_to_state_dict(_flatten(jax.grad(
        lambda v: jm.apply(v, *_jax_batch(good).values())["loss"])(
            variables)), tm)
    first_grad = {k: v.numpy() for k, v in first_grad.items()}
    gen = make_generator(0)
    for i, (a, batch) in enumerate([(1, good), (1, nan), (2, accum)]):
        j_state, jm_metrics = j_steps[a](j_state, _jax_batch(batch),
                                         jax.random.PRNGKey(i))
        metrics = steps[a](state, _torch_batch(batch), gen)
        skipped = float(jm_metrics["skipped"])
        assert float(metrics["skipped"]) == skipped == (1.0 if i == 1 else 0.0)
        if not skipped:
            np.testing.assert_allclose(float(metrics["grad_norm"]),
                                       float(jm_metrics["grad_norm"]),
                                       rtol=1e-4)
            np.testing.assert_allclose(float(metrics["loss"]),
                                       float(jm_metrics["loss"]), rtol=1e-5)
        want = flax_to_state_dict(_flatten(j_state.params), tm)
        _assert_params_close(_params(tm),
                             {k: v.numpy() for k, v in want.items()},
                             optim, lr, first_grad)
        if i == 0:   # the clip acts: the norm is above grad_clip
            assert float(metrics["grad_norm"]) > 5.0
    assert state.step == int(j_state.step) == 3
    assert state.n_applied == 2
    if optim == "adam":
        assert opt.state[next(iter(tm.parameters()))]["step"] == 2


def test_skipped_step_leaves_params_and_adam_untouched():
    _, _, _, tm = tiny_models(0, **NO_DROPOUT)
    opt, schedule = build_optimizer(tm, 1e-3, 3, "adam")
    state = TrainState(tm, opt)
    step = build_train_step(schedule, 1, 5.0)
    step(state, _torch_batch(_batch(seed=2)), None)
    before = _params(tm)
    adam = {k: v.clone() for k, v in
            opt.state[next(iter(tm.parameters()))].items()}
    nan = _batch(seed=3)
    nan["features"][0, 0, 0] = np.inf
    metrics = step(state, _torch_batch(nan), None)
    assert float(metrics["skipped"]) == 1.0
    assert not np.isfinite(float(metrics["grad_norm"]))
    after = _params(tm)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    for k, v in opt.state[next(iter(tm.parameters()))].items():
        assert torch.equal(v, adam[k])
    assert (state.step, state.n_applied) == (2, 1)


@pytest.mark.parametrize("normalize_length", [False, True])
def test_label_smoothing_matches_jax(normalize_length):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    target = rng.integers(0, 11, (3, 7)).astype(np.int32)
    target[1, 4:] = -1
    target[2, 1:] = -1
    want = jax_lsm(jnp.asarray(logits), jnp.asarray(target), 0.1, -1,
                   normalize_length)
    got = label_smoothing_loss(torch.from_numpy(logits),
                               torch.from_numpy(target), 0.1, -1,
                               normalize_length)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _feats(seed=0, b=3, t=90, f=80):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, f)).astype(np.float32),
            np.array([t, 61, 17][:b], np.int32))


def test_spec_augment_with_jax_spans():
    feats, lens = _feats()
    key = jax.random.PRNGKey(3)
    want = jspec.spec_augment(jnp.asarray(feats), jnp.asarray(lens), key,
                              3, 2, 50, 10)
    # the spans spec_augment draws, drawn again from the same keys
    kt, kf = jax.random.split(key)
    b, _, f = feats.shape
    ts, tl = jspec._rand_span(kt, jnp.asarray(lens)[:, None], 50, (b, 3))
    fs, fl = jspec._rand_span(kf, jnp.full((b, 1), f), 10, (b, 2))
    got = specaug.apply_spec_augment(
        torch.from_numpy(feats), *(torch.from_numpy(np.asarray(x)).long()
                                   for x in (ts, tl, fs, fl)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the port's own draws keep within each utterance's frames
    ts, tl, fs, fl = specaug.draw_spec_augment(
        torch.from_numpy(lens), f, make_generator(1), 3, 2, 50, 10)
    assert (ts < torch.from_numpy(lens)[:, None]).all()
    assert ((tl >= 1) & (tl <= 50)).all() and ((fl >= 1) & (fl <= 10)).all()


def test_spec_substitute_with_jax_spans():
    feats, lens = _feats(1)
    key = jax.random.PRNGKey(5)
    want = jspec.spec_substitute(jnp.asarray(feats), jnp.asarray(lens), key,
                                 30, 3)
    b = feats.shape[0]
    starts, lengths, poss = [], [], []
    for k in jax.random.split(key, 3):
        k1, k2, k3 = jax.random.split(k, 3)
        u = jax.random.uniform(k1, (b,))
        start = (u * jnp.maximum(jnp.asarray(lens), 1)).astype(jnp.int32)
        starts.append(start)
        lengths.append(jax.random.randint(k2, (b,), 1, 31))
        poss.append((jax.random.uniform(k3, (b,))
                     * (start + 1).astype(jnp.float32)).astype(jnp.int32))
    spans = [torch.from_numpy(np.stack([np.asarray(x) for x in xs])).long()
             for xs in (starts, lengths, poss)]
    got = specaug.apply_spec_substitute(torch.from_numpy(feats), *spans)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dropout_rate_scale_and_seed():
    drop = Dropout(0.1).train()
    x = torch.ones(1_000_000)
    with pytest.raises(RuntimeError, match="generator"):
        drop(x)
    drop.generator = make_generator(7)
    y = drop(x)
    kept = (y != 0).float().mean().item()
    # keep 0.9 exactly (not 230/256 = 0.8984): 4 sigma is 0.0012
    assert abs(kept - 0.9) < 0.0012
    assert torch.all((y == 0) | (y == torch.tensor(1 / 0.9)))
    drop.generator = make_generator(7)
    assert torch.equal(drop(x), y)
    drop.eval()
    assert drop(x) is x


def test_model_dropout_only_in_train_mode():
    _, _, _, tm = tiny_models(0)            # dropout_rate 0.1
    batch = _torch_batch(_batch(seed=8))
    tm.eval()
    ref = tm(*batch.values())["loss"]
    assert torch.equal(tm(*batch.values())["loss"], ref)
    tm.train()
    set_generator(tm, make_generator(3))
    a = tm(*batch.values())["loss"]
    set_generator(tm, make_generator(3))
    b = tm(*batch.values())["loss"]
    assert torch.equal(a, b) and not torch.equal(a, ref)
