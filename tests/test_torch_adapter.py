"""openeat_torch's fine-tuning adapters against the JAX package's, on the
CPU, float32 on both sides.

- Adapter (d = 64, down_size 16, dropout 0.1) at scalar 0.1 and at -1
  (a learned scale) against the JAX module with residual=False (as the
  layers build it), in eval and in training with both dropout sites'
  masks injected into both frameworks in call order (the inner one
  after the ReLU, then the one on the output), within 1e-5;
- the tiny Conformer (tests/_torch_parity.py, dropout 0) with adapters
  in every encoder and decoder block: encode and decoder_logits, the
  KV-cached decoder_step at four positions, and, on a causal chunked
  copy, encode_chunk (the adapter in forward_chunk) against JAX's
  methods within 1e-4; the training loss within 1e-5 relative and every
  gradient, the adapters' included, within 1e-4 of its tensor's largest
  plus 1e-7 of the model's;
- --only_adapter (utils/optim.py): one SGD step of build_train_step
  (clip 5, active) against JAX's masked optimizer changes exactly the
  adapter tensors, by JAX's update within 1e-6, and its clip norm,
  counted over every gradient as JAX counts it, within 1e-4; the
  trainer's flag on the tiny corpus leaves every other tensor of its
  checkpoint bit-equal to the init;
- the weight bridge fills the adapter leaves (norm, down_proj, up_proj,
  scale) in the port's layout, and quantize_model quantizes exactly the
  Dense kernels the JAX package's quantize_params quantizes, the
  adapters' included, with the same bits.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openeat_tpu.modules.dropout as jax_dropout
from openeat_tpu.models.asr_model import ASRModel
from openeat_tpu.modules.feed_forward import Adapter as JaxAdapter
from openeat_tpu.parallel.train_step import TrainState as JaxTrainState
from openeat_tpu.parallel.train_step import \
    build_train_step as jax_build_train_step
from openeat_tpu.utils.checkpoint import _flatten
from openeat_tpu.utils.optim import build_optimizer as jax_build_optimizer
from openeat_tpu.utils.quantize import QTensor
from openeat_tpu.utils.quantize import quantize_params as jax_quantize
from openeat_torch.bin import train
from openeat_torch.modules.dropout import Dropout
from openeat_torch.modules.feed_forward import Adapter
from openeat_torch.modules.layers import Dense
from openeat_torch.parallel.train_step import TrainState, build_train_step
from openeat_torch.utils.optim import build_optimizer
from openeat_torch.utils.param_bridge import flax_to_state_dict
from openeat_torch.utils.quantize import quantize_model
from tests._torch_parity import (FEAT_DIM, TINY_CONF, VOCAB, _draw,
                                 tiny_models, to_np)
from tests.make_tiny_data import build as build_tiny

torch.set_num_threads(1)
ADAPT = dict(encoder_use_adapter=True, decoder_use_adapter=True,
             down_size=16, scalar=0.1, dropout_rate=0.0)
RATE = 0.1


def _inject(monkeypatch, masks: list) -> None:
    """Both frameworks' Dropout take the next of `masks` (keep, scaled
    by 1 / (1 - rate)) in call order, each from its own copy."""
    j_masks, t_masks = list(masks), list(masks)

    def j_call(self, x, deterministic=True):
        if deterministic or self.rate == 0.0:
            return x
        return jnp.where(jnp.asarray(j_masks.pop(0)), x / (1 - self.rate),
                         0.0)

    def t_call(self, x, shard=None):
        if not self.training or self.rate == 0.0:
            return x
        return torch.where(torch.from_numpy(t_masks.pop(0)),
                           x / (1 - self.rate), 0.0)

    monkeypatch.setattr(jax_dropout.Dropout, "__call__", j_call)
    monkeypatch.setattr(Dropout, "forward", t_call)


@pytest.mark.parametrize("scalar", [0.1, -1.0], ids=["fixed", "learned"])
def test_adapter_matches_jax(monkeypatch, scalar):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    jmod = JaxAdapter(64, RATE, 16, scalar, residual=False)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(_draw(rng, path[-1].key, leaf.shape)),
        shapes)
    if scalar == -1.0:   # a learned scale away from its init of 1
        variables["params"]["scale"] = jnp.asarray([0.7], jnp.float32)
    tmod = Adapter(64, RATE, 16, scalar)
    tmod.load_state_dict(flax_to_state_dict(_flatten(variables), tmod))
    tmod.eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    want = jmod.apply(variables, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    masks = [rng.random((2, 9, 16)) >= RATE, rng.random((2, 9, 64)) >= RATE]
    _inject(monkeypatch, masks)
    tmod.train()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    want = jmod.apply(variables, jnp.asarray(x), deterministic=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert not np.allclose(got.numpy(), tmod.eval()(torch.from_numpy(x))
                           .detach().numpy())


def _batch(seed=1, b=3, t=57):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, t, FEAT_DIM)).astype(np.float32)
    ys = rng.integers(1, VOCAB - 1, (b, 8)).astype(np.int32)
    ys_lens = np.array([8, 3, 6][:b], np.int32)
    for i, n in enumerate(ys_lens):
        ys[i, n:] = -1
    return {"features": feats,
            "features_length": np.array([t, t - 16, 23][:b], np.int32),
            "targets": ys, "targets_length": ys_lens}


@pytest.fixture(scope="module")
def models():
    return tiny_models(4, **ADAPT)


def test_encode_decoder_logits_and_cached_step_match_jax(models):
    jm, v, _, tm = models
    batch = _batch(2)
    feats, lens = batch["features"], batch["features_length"]
    jenc, jlens = jm.apply(v, jnp.asarray(feats), jnp.asarray(lens),
                           method=ASRModel.encode)
    with torch.no_grad():
        enc, enc_lens = tm.encode(torch.from_numpy(feats),
                                  torch.from_numpy(lens).long())
    np.testing.assert_allclose(to_np(enc), to_np(jenc), atol=1e-4)
    b, t = enc.shape[:2]
    tokens = np.array([[VOCAB - 1, 3, 7, 7, 12], [VOCAB - 1, 5, 0, 9, 2],
                       [VOCAB - 1, 8, 8, 1, 4]])
    ys_lens = np.array([5, 4, 5])
    jfull = jm.apply(v, jenc, jlens, jnp.asarray(tokens),
                     jnp.asarray(ys_lens), method=ASRModel.decoder_logits)
    jcache = jm.apply(v, jenc, b, 6, method=ASRModel.decoder_init_cache)
    with torch.no_grad():
        full = tm.decoder_logits(enc, enc_lens, torch.from_numpy(tokens),
                                 torch.from_numpy(ys_lens))
        np.testing.assert_allclose(to_np(full), to_np(jfull), atol=1e-4)
        cache = tm.decoder_init_cache(enc, b, 6)
        for pos in range(4):
            lp, cache = tm.decoder_step(torch.from_numpy(tokens[:, pos]),
                                        pos, cache, enc_lens, t)
            jlp, jcache = jm.apply(v, jnp.asarray(tokens[:, pos]),
                                   jnp.int32(pos), jcache, jlens, t,
                                   method=ASRModel.decoder_step)
            np.testing.assert_allclose(to_np(lp), to_np(jlp), atol=1e-4)
            np.testing.assert_allclose(to_np(lp), to_np(full[:, pos]),
                                       atol=1e-4)


def test_encode_chunk_with_adapters_matches_jax():
    conf = dict(ADAPT, d_model=32, attention_heads=2, linear_units=64,
                cnn_module_kernel=5, causal=True, static_chunk_size=4,
                num_left_chunks=2)
    jm, v, _, tm = tiny_models(6, **conf)
    rng = np.random.default_rng(3)
    win = rng.standard_normal((1, 19, FEAT_DIM)).astype(np.float32)
    kc = [rng.standard_normal((1, 8, 2, 16)).astype(np.float32)
          for _ in range(2)]
    vc = [rng.standard_normal((1, 8, 2, 16)).astype(np.float32)
          for _ in range(2)]
    cnn = [rng.standard_normal((1, 4, 32)).astype(np.float32)
           for _ in range(2)]
    j = jm.apply(v, jnp.asarray(win), jnp.int32(4),
                 tuple(map(jnp.asarray, kc)), tuple(map(jnp.asarray, vc)),
                 jnp.int32(4), tuple(map(jnp.asarray, cnn)), jnp.int32(4),
                 method=ASRModel.encode_chunk)
    t = tm.encode_chunk(torch.from_numpy(win), 4,
                        [torch.from_numpy(a) for a in kc],
                        [torch.from_numpy(a) for a in vc], 4,
                        [torch.from_numpy(a) for a in cnn], 4)
    np.testing.assert_allclose(to_np(t[0]), to_np(j[0]), atol=1e-4)
    for got, want in zip(t[3], j[3]):
        np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-4)


def test_model_loss_and_gradients_match_jax(models):
    jm, v, _, tm = models
    batch = _batch()

    def loss_fn(variables):
        m = jm.apply(variables, *(jnp.asarray(x) for x in batch.values()))
        return m["loss"], m

    (_, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v)
    tm.train()
    tm.zero_grad()
    metrics = tm(*(torch.from_numpy(x) for x in batch.values()))
    metrics["loss"].backward()
    tm.eval()
    for key in ("loss", "loss_ctc", "loss_att", "acc"):
        np.testing.assert_allclose(float(metrics[key].detach()),
                                   float(j_metrics[key]), rtol=1e-5,
                                   err_msg=key)
    want = flax_to_state_dict(_flatten(j_grads), tm)
    g_max = max(float(g.abs().max()) for g in want.values())
    n_adapter = 0
    for name, p in tm.named_parameters():
        ref = want[name].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max() + 1e-7 * g_max, (name, err)
        n_adapter += "adapter" in name and bool(np.abs(ref).max() > 0)
    # 2 encoder and 2 decoder blocks, 6 tensors an adapter
    assert n_adapter == 4 * 6


def test_only_adapter_step_matches_jax():
    jm, v, _, tm = tiny_models(4, **ADAPT)
    tx, _ = jax_build_optimizer(1.0, 1, "sgd", v, only_adapter=True)
    j_state = JaxTrainState(v, tx.init(v), jnp.zeros((), jnp.int32))
    batch = _batch(5)
    j_state, j_metrics = jax.jit(jax_build_train_step(
        jm, tx, 1, 5.0, donate=False))(
        j_state, {k: jnp.asarray(x) for k, x in batch.items()},
        jax.random.PRNGKey(0))
    opt, schedule = build_optimizer(tm, 1.0, 1, "sgd", only_adapter=True)
    n_opt = sum(len(g["params"]) for g in opt.param_groups)
    assert n_opt == sum("adapter" in n for n, _ in tm.named_parameters())
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    metrics = build_train_step(schedule, 1, 5.0)(
        TrainState(tm, opt), {k: torch.from_numpy(x)
                              for k, x in batch.items()}, None)
    norm = float(metrics["grad_norm"])
    assert norm > 5.0   # the clip acts, over every gradient
    np.testing.assert_allclose(norm, float(j_metrics["grad_norm"]),
                               rtol=1e-4)
    want = flax_to_state_dict(_flatten(j_state.params), tm)
    for name, p in tm.named_parameters():
        got = p.detach()
        if "adapter" in name:
            assert not torch.equal(got, before[name]), name
            err = float((got - want[name]).abs().max())
            assert err <= 1e-6 * (1 + float(want[name].abs().max())), name
        else:
            assert torch.equal(got, before[name]), name
            assert torch.equal(want[name], before[name]), name


def test_only_adapter_cli_changes_only_the_adapters(tmp_path):
    data = build_tiny(str(tmp_path), n_utts=6, seed=9, max_dur=1.2)
    cfg = {"model_conf": dict(TINY_CONF, **dict(ADAPT, dropout_rate=0.1)),
           "collate_conf": {"spec_aug": True},
           "dataset_conf": {"batch_type": "dynamic",
                            "max_frames_in_batch": 400},
           "optim_conf": {"lr": 0.002}, "warmup_steps": 2, "seed": 3}
    cfg_path = str(tmp_path / "train.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    common = ["--config", cfg_path, "--train_data", data["manifest"],
              "--cv_data", data["manifest"], "--dict", data["dict"],
              "--device", "cpu", "--num_workers", "1", "--max_epoch", "1"]
    train.main(common + ["--exp_dir", str(tmp_path / "init")])
    init = torch.load(tmp_path / "init" / "epoch_1.pt", weights_only=True)
    state = train.main(common + ["--exp_dir", str(tmp_path / "ft"),
                                 "--checkpoint",
                                 str(tmp_path / "init" / "epoch_1.pt"),
                                 "--only_adapter"])
    # an init, not a resume: the epoch and step counts start afresh
    assert state.step == json.loads(
        (tmp_path / "init" / "epoch_1.json").read_text())["step"]
    tuned = torch.load(tmp_path / "ft" / "epoch_1.pt", weights_only=True)
    assert set(tuned) == set(init)
    for k in init:
        if "adapter" in k:
            assert not torch.equal(tuned[k], init[k]), k
        else:
            assert torch.equal(tuned[k], init[k]), k


def test_bridge_carries_the_adapter_leaves(models):
    _, _, flat, tm = models
    leaves = sorted(k for k in flat if "/adapter/" in k)
    assert len(leaves) == 4 * 6
    state = tm.state_dict()
    for key in leaves:
        layer, leaf = key.split("/adapter/")
        base = layer[len("params/"):].replace("/", ".") + ".adapter."
        if leaf.endswith("kernel"):
            got, want = state[base + leaf.split("/")[0] + ".weight"], \
                flat[key].T
        else:
            name = leaf.replace("/", ".").replace("norm.scale",
                                                  "norm.weight")
            got, want = state[base + name], flat[key]
        np.testing.assert_array_equal(to_np(got), want)
    learned = tiny_models(4, **dict(ADAPT, scalar=-1))
    scales = [k for k in learned[2] if k.endswith("/adapter/scale")]
    assert len(scales) == 4
    for key in scales:
        name = key[len("params/"):].replace("/", ".")
        np.testing.assert_array_equal(
            to_np(learned[3].state_dict()[name]), learned[2][key])


def test_quantize_picks_the_kernels_jax_picks():
    _, v, _, tm = tiny_models(4, **dict(ADAPT, down_size=64))
    jq = jax_quantize(v)
    picked = {}

    def walk(tree, path):
        if isinstance(tree, QTensor):
            picked[".".join(path[1:-1])] = tree
        elif isinstance(tree, dict):
            for k, sub in tree.items():
                walk(sub, path + [k])
    walk(jq, [])
    quantize_model(tm)
    got = {n: m for n, m in tm.named_modules()
           if isinstance(m, Dense) and m.q is not None}
    assert set(got) == set(picked)
    assert sum(".adapter." in n for n in got) == 4 * 2
    for name, m in got.items():
        np.testing.assert_array_equal(m.q.numpy(),
                                      np.asarray(picked[name].q).T)
        np.testing.assert_array_equal(m.scale.numpy(),
                                      np.asarray(picked[name].scale))
