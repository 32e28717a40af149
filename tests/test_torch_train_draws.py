"""The per-step random draws of training, held to the JAX package's.

- Dropout sites: every dropout that one training forward of the
  flagship's structure (macaron, rel_pos, conv module, 3 + 3 decoders;
  and its causal static-chunk variant) applies, recorded in each
  package by wrapping its Dropout's call inside the test: the site, the
  tensor's shape and the rate, in call order, must be equal. JAX names
  an inline Dropout `Dropout_0` where the port names it `dropout`, and
  keeps the encoder's positional encoding beside the embedding where
  the port keeps it inside; NAME_MAP states both.
- SpecAugment spans: the starts and lengths of the time and frequency
  masks, drawn over many utterances by
  openeat_tpu/ops/specaug.py:spec_augment (its `_rand_span` wrapped to
  record them) and by the port's draw_spec_augment: the same bounds, and
  means within five standard errors. The generators differ, so the
  draws are compared as distributions.
- Batch order: each trainer's own epoch loop (openeat_tpu.bin.train and
  openeat_torch.bin.train, with their feeders and executors replaced by
  stand-ins that only consume the loader) over a corpus at the lmhard
  drive's dataset_conf (static 64, sorted, 10-400 frames) at seed 777:
  the utterance keys of every step of epochs 0 and 1 are equal.

What the port deliberately computes otherwise (ROADMAP Queue 3 item 8)
stays so: JAX's byte-mask dropout realises a keep probability of
round(256 (1 - rate)) / 256 (230/256 at rate 0.1), the port exactly
1 - rate; `test_dropout_realised_rates` states both.
"""

from __future__ import annotations

import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openeat_torch.bin import train as torch_train
from openeat_torch.modules import dropout as torch_dropout
from openeat_torch.ops import specaug as torch_specaug
from openeat_torch.quality import confs
from openeat_tpu.bin import train as jax_train
from openeat_tpu.modules.dropout import Dropout as JaxDropout
from openeat_tpu.ops import specaug as jax_specaug
from openeat_tpu.utils.executor import Executor as JaxExecutor
from openeat_torch.utils.executor import Executor as TorchExecutor
from tests._torch_parity import tiny_models
from tests.make_tiny_data import build as build_tiny

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = os.path.join(REPO, "examples", "aishell", "conf",
                    "train_conformer_tpu.yaml")

# the flagship's structure at a small width: 3 + 3 decoder blocks
FLAGSHIP = dict(d_model=32, attention_heads=4, linear_units=64,
                encoder_num_blocks=2, decoder_num_blocks=3,
                r_decoder_num_blocks=3, dropout_rate=0.1)
# JAX site -> the port's, where the two name a site differently
NAME_MAP = (("/Dropout_0", "/dropout"), ("encoder/pos_enc/",
                                          "encoder/embed/pos_enc/"))


def _jax_site(path: tuple) -> str:
    site = "/".join(path)
    for a, b in NAME_MAP:
        site = site.replace(a, b)
    return site


def _batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((2, 90, 80)).astype(np.float32)
    return (feats, np.array([90, 71], np.int32),
            rng.integers(2, 39, (2, 6)).astype(np.int32),
            np.array([6, 4], np.int32))


def dropout_inventories(**conf) -> tuple[list, list]:
    """(JAX's, the port's) dropout calls of one training forward, each
    (site, shape, rate) in call order."""
    jmodel, variables, _, tmodel = tiny_models(0, **dict(FLAGSHIP, **conf))
    feats, flen, tgt, tlen = _batch()
    jax_calls = []

    def record(next_fun, args, kwargs, ctx):
        if isinstance(ctx.module, JaxDropout) and ctx.method_name == \
                "__call__":
            det = kwargs.get("deterministic", args[1] if len(args) > 1
                             else True)
            assert det is False
            jax_calls.append((_jax_site(ctx.module.path),
                              tuple(args[0].shape), ctx.module.rate))
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(record):
        jmodel.apply(variables, jnp.asarray(feats), jnp.asarray(flen),
                     jnp.asarray(tgt), jnp.asarray(tlen),
                     deterministic=False,
                     rngs={"dropout": jax.random.PRNGKey(0)})

    names = {id(m): n.replace(".", "/") for n, m in tmodel.named_modules()}
    torch_calls = []
    forward = torch_dropout.Dropout.forward

    def recorded(self, x, shard=None):
        assert self.training
        torch_calls.append((names[id(self)], tuple(x.shape), self.rate))
        return forward(self, x, shard)

    tmodel.train()
    torch_dropout.set_generator(tmodel, torch.Generator().manual_seed(0))
    torch_dropout.Dropout.forward = recorded
    try:
        tmodel(torch.from_numpy(feats), torch.from_numpy(flen),
               torch.from_numpy(tgt).long(), torch.from_numpy(tlen).long())
    finally:
        torch_dropout.Dropout.forward = forward
    return jax_calls, torch_calls


@pytest.mark.parametrize("conf", [
    {},
    dict(causal=True, static_chunk_size=4, num_left_chunks=-1),
], ids=["flagship", "causal_static_chunk"])
def test_dropout_sites_equal_jax(conf):
    jax_calls, torch_calls = dropout_inventories(**conf)
    assert torch_calls == jax_calls
    sites = {s.rsplit("/", 1)[-1] for s, _, _ in jax_calls}
    # the positional-encoding, attention, FFN and residual (after the
    # macaron FFN, attention, conv module and FFN) dropouts, in the
    # encoder and both decoders
    assert sites == {"dropout", "drop", "attn_dropout"}
    for part in ("encoder/embed/pos_enc", "feed_forward_macaron",
                 "decoder/left_decoder", "decoder/right_decoder",
                 "src_attn"):
        assert any(part in s for s, _, _ in jax_calls), part
    # four residual dropouts a Conformer block: macaron FFN, attention,
    # conv module, FFN
    blocks = FLAGSHIP["encoder_num_blocks"]
    assert sum(s.startswith("encoder/") and s.endswith("/drop")
               for s, _, _ in jax_calls) == 4 * blocks


def test_dropout_realised_rates():
    """Queue 3 item 8: JAX keeps round(256 (1 - rate)) / 256 of the
    elements, the port 1 - rate."""
    x = jnp.ones((256, 1024))
    kept = JaxDropout(0.1).apply({}, x, deterministic=False,
                                 rngs={"dropout": jax.random.PRNGKey(1)})
    drop = torch_dropout.Dropout(0.1).train()
    drop.generator = torch.Generator().manual_seed(1)
    port = drop(torch.ones(256, 1024))
    n = x.size
    jax_keep = float((kept != 0).mean())
    port_keep = float((port != 0).float().mean())
    se = np.sqrt(0.1 * 0.9 / n)
    assert abs(jax_keep - 230 / 256) < 5 * se
    assert abs(port_keep - 0.9) < 5 * se
    assert float(kept.max()) == pytest.approx(256 / 230)
    assert float(port.max()) == pytest.approx(1 / 0.9)


def _spans_jax(lens: np.ndarray, num_freq: int, spec: dict, seed: int):
    recorded = []
    rand_span = jax_specaug._rand_span

    def record(rng, upper, max_len, shape):
        start, length = rand_span(rng, upper, max_len, shape)
        recorded.append((np.asarray(start), np.asarray(length)))
        return start, length

    jax_specaug._rand_span = record
    try:
        jax_specaug.spec_augment(
            jnp.zeros((len(lens), 8, num_freq)), jnp.asarray(lens),
            jax.random.PRNGKey(seed), **spec)
    finally:
        jax_specaug._rand_span = rand_span
    (ts, tl), (fs, fl) = recorded
    return ts, tl, fs, fl


def _spans_torch(lens: np.ndarray, num_freq: int, spec: dict, seed: int):
    return tuple(t.numpy() for t in torch_specaug.draw_spec_augment(
        torch.from_numpy(lens), num_freq, torch.Generator().manual_seed(seed),
        **spec))


def test_spec_augment_spans_match_jax_in_distribution():
    """The lmhard drive's masks (2 x 15 frames, 2 x 10 bins of 80) over
    utterances of 10-400 frames: starts in [0, len - 1] and [0, 79],
    lengths in [1, max], the same extremes reached, and each mean (the
    start as a fraction of its range) within five standard errors."""
    spec = confs.synth_train_conf(BASE, "lmhard", 60)["collate_conf"][
        "spec_aug_conf"]
    spec = {k: spec[k] for k in ("num_t_mask", "num_f_mask", "max_t",
                                 "max_f")}
    assert spec == dict(num_t_mask=2, num_f_mask=2, max_t=15, max_f=10)
    lens = np.random.default_rng(7).integers(10, 401, 20000).astype(np.int32)
    jax_spans = _spans_jax(lens, 80, spec, 0)
    torch_spans = _spans_torch(lens, 80, spec, 0)
    upper = (lens[:, None], 80)
    for name, j, t, hi in (("time start", jax_spans[0], torch_spans[0],
                            upper[0]),
                           ("time length", jax_spans[1], torch_spans[1],
                            spec["max_t"] + 1),
                           ("freq start", jax_spans[2], torch_spans[2],
                            upper[1]),
                           ("freq length", jax_spans[3], torch_spans[3],
                            spec["max_f"] + 1)):
        assert j.shape == t.shape, name
        lo = 1 if "length" in name else 0
        for d in (j, t):
            assert d.min() == lo and (d < hi).all(), name
            assert (d == hi - 1).any(), name
        # starts as a fraction of their own range, lengths as they are
        jf, tf = ((j / hi, t / hi) if "start" in name
                  else (j.astype(float), t.astype(float)))
        se = np.sqrt(jf.var() / jf.size + tf.var() / tf.size)
        assert abs(jf.mean() - tf.mean()) < 5 * se, (name, jf.mean(),
                                                      tf.mean(), se)


class _KeysOnly:
    """A DeviceFeeder stand-in: a training loader's batches pass as
    their keys, with no features computed, and are recorded; any other
    feed goes to the package's own feeder."""

    def __init__(self, real, record: list, loader, *args, train=False,
                 **kwargs):
        self.loader, self.record = loader, record
        self.keys_only = train and hasattr(loader, "shuffle_batches")
        self.real = None if self.keys_only else real(loader, *args,
                                                     train=train, **kwargs)

    def __iter__(self):
        if self.real is not None:
            yield from self.real
            return
        keys = [list(k) for k, _ in self.loader]
        self.record.append(keys)
        yield from ((k, None) for k in keys)


def _consume(batches):
    for _ in batches:
        pass


@pytest.fixture(scope="module")
def epoch_orders(tmp_path_factory):
    """{package: [epoch 0's step keys, epoch 1's]} from each trainer's
    own epoch loop at the lmhard dataset_conf and seed 777."""
    root = tmp_path_factory.mktemp("draws")
    data = build_tiny(str(root / "data"), n_utts=150, seed=3, min_dur=0.3,
                      max_dur=4.2)
    cfg = {"model_conf": dict(FLAGSHIP, decoder_num_blocks=1,
                              r_decoder_num_blocks=1),
           "dataset_conf": confs.synth_train_conf(BASE, "lmhard", 2)[
               "dataset_conf"],
           "collate_conf": {"spec_aug": False}, "max_epoch": 2,
           "optim_conf": {"lr": 0.001}, "warmup_steps": 4}
    assert cfg["dataset_conf"]["batch_size"] == 64
    path = root / "conf.json"
    path.write_text(json.dumps(cfg))
    argv = ["--config", str(path), "--train_data", data["manifest"],
            "--cv_data", data["manifest"], "--dict", data["dict"],
            "--num_workers", "1"]
    mp = pytest.MonkeyPatch()
    orders = {}
    try:
        rec = orders["jax"] = []
        real = jax_train.DeviceFeeder
        mp.setattr(jax_train, "DeviceFeeder",
                   lambda *a, **k: _KeysOnly(real, rec, *a, **k))
        mp.setattr(JaxExecutor, "train",
                   lambda self, state, batches, rng, epoch:
                   (_consume(batches), (state, {}))[1])
        mp.setattr(JaxExecutor, "cv",
                   lambda self, params, batches, epoch=0:
                   (_consume(batches), {"cv_loss": 0.0, "cv_acc": 0.0})[1])
        jax_train.main(argv + ["--exp_dir", str(root / "jax")])

        rec = orders["torch"] = []
        real_t = torch_train.DeviceFeeder
        mp.setattr(torch_train, "DeviceFeeder",
                   lambda *a, **k: _KeysOnly(real_t, rec, *a, **k))
        mp.setattr(TorchExecutor, "train",
                   lambda self, state, batches, gen, epoch, chunk=None:
                   (_consume(batches), {})[1])
        mp.setattr(TorchExecutor, "cv",
                   lambda self, batches, epoch=0:
                   (_consume(batches), {"cv_loss": 0.0, "cv_acc": 0.0})[1])
        torch_train.main(argv + ["--exp_dir", str(root / "torch"),
                                 "--device", "cpu"])
    finally:
        mp.undo()
    return orders


def test_batch_order_equals_jax_through_each_trainer(epoch_orders):
    jax_epochs, torch_epochs = epoch_orders["jax"], epoch_orders["torch"]
    assert len(jax_epochs) == len(torch_epochs) == 2
    assert torch_epochs == jax_epochs
    e0, e1 = torch_epochs
    # static batches of 64 (the last one short), every utterance once an
    # epoch, the two epochs in different orders
    assert [len(k) for k in e0[:-1]] == [64] * (len(e0) - 1) and e0[-1]
    assert sorted(sum(e0, [])) == sorted(sum(e1, []))
    assert len(set(sum(e0, []))) == len(sum(e0, []))
    assert len(e0) >= 2 and e0 != e1
