"""The rest of the AIShell recipe on openeat_torch, on the CPU:
- bin.train_lm (--device cpu) trains a tiny LM, autoregressive and
  masked, and with accum_grad 2, for 2 epochs: epoch_N.pt + .json,
  train.json, metrics.jsonl with finite losses, and a sentencepiece
  --bpe_model without sentencepiece refused as JAX refuses it;
- average_checkpoints over three weight sets saved by each package
  (orbax + .yaml there, .pt + .json here), with --val_best on cv_loss
  and without: bit-equal to JAX's average, and bin.average_model writes
  <dst>.pt and <dst>.json;
- corpus_wer against JAX's on strings drawn by hypothesis, in char and
  word mode, with the per-cluster split and the verbose alignment;
- model_conf use_dynamic_chunk builds and bin.train trains it (the
  streaming slice ported it; it was refused before).
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from openeat_tpu.dataset.bpe import load_bpe as jax_load_bpe
from openeat_tpu.utils import checkpoint as jax_ckpt
from openeat_tpu.utils.checkpoint import _flatten
from openeat_tpu.utils.wer import corpus_wer as jax_corpus_wer
from openeat_torch.bin import average_model, train, train_lm
from openeat_torch.dataset.text import load_dict
from openeat_torch.models.asr_model import build_asr_model
from openeat_torch.utils import checkpoint as ckpt_lib
from openeat_torch.utils.param_bridge import flax_to_state_dict
from openeat_torch.utils.wer import corpus_wer
from tests._torch_parity import FEAT_DIM, TINY_CONF, VOCAB
from tests.make_tiny_data import build as build_tiny
from tests.test_torch_lm import LM_CONF, lm_models

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_recipe")
    return dict(root=root, data=build_tiny(str(root), n_utts=14, seed=8))


def _train_lm(corpus, exp, conf, extra=(), accum_grad=1):
    cfg = {"model_conf": conf, "dataset_conf": {"batch_size": 4},
           "optim_conf": {"lr": 0.002}, "warmup_steps": 2,
           "log_interval": 1, "seed": 3, "max_epoch": 2,
           "accum_grad": accum_grad}
    cfg_path = str(exp) + ".json"
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    text = corpus["data"]["text"]
    return train_lm.main(["--config", cfg_path, "--train_data", text,
                          "--cv_data", text, "--dict",
                          corpus["data"]["dict"], "--exp_dir", str(exp),
                          "--device", "cpu", "--num_workers", "1", *extra])


@pytest.mark.parametrize("autoregressive,accum_grad",
                         [(True, 1), (False, 1), (True, 2)],
                         ids=["ar", "mlm", "ar_accum2"])
def test_train_lm_two_epochs(corpus, autoregressive, accum_grad):
    exp = corpus["root"] / f"lm_{autoregressive}_{accum_grad}"
    state = _train_lm(corpus, exp, dict(LM_CONF, dropout_rate=0.1,
                                        autoregressive=autoregressive),
                      accum_grad=accum_grad)
    for name in ("epoch_1.pt", "epoch_1.json", "epoch_2.pt", "epoch_2.json",
                 "train.json", "metrics.jsonl", "train.log"):
        assert (exp / name).exists(), name
    with open(exp / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if r["kind"] == "train"]
    assert len(steps) == state.step == 2 * 4          # 14 lines, batch 4
    assert all(np.isfinite(r["loss"]) for r in steps)
    info = json.loads((exp / "epoch_2.json").read_text())
    assert info["step"] == state.step and np.isfinite(info["cv_loss"])
    resolved = json.loads((exp / "train.json").read_text())
    assert resolved["vocab_size"] == len(load_dict(corpus["data"]["dict"]))
    assert resolved["model_conf"]["autoregressive"] is autoregressive


@pytest.mark.parametrize("extra,match", [(["--bpe_model", "b.model"],
                                          "bpe")])
def test_train_lm_refuses_unported_flags(corpus, extra, match):
    """--bpe_model is ported; a sentencepiece .model without
    sentencepiece raises ImportError, as the JAX trainer's load_bpe
    does, before any file is written."""
    try:
        import sentencepiece  # noqa: F401
        pytest.skip("sentencepiece is installed")
    except ImportError:
        pass
    exp = corpus["root"] / "refused"
    with pytest.raises(ImportError, match=match):
        _train_lm(corpus, exp, LM_CONF, extra)
    with pytest.raises(ImportError, match=match):
        jax_load_bpe(extra[1])
    assert not (exp / "epoch_1.pt").exists()


@pytest.mark.parametrize("val_best", [True, False],
                         ids=["val_best", "last_n"])
def test_average_checkpoints_bit_equal_to_jax(tmp_path, val_best):
    _, variables, tlm = lm_models(3)
    rng = np.random.default_rng(11)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for epoch, cv in ((1, 1.0), (2, 3.0), (3, 2.0)):
        weights = jax.tree.map(
            lambda x: x + jnp.asarray(rng.standard_normal(x.shape),
                                      jnp.float32), variables)
        info = {"epoch": epoch, "cv_loss": cv}
        jax_ckpt.save_checkpoint(str(jdir), f"epoch_{epoch}", weights, info)
        ckpt_lib.save_checkpoint(
            str(tdir), f"epoch_{epoch}",
            flax_to_state_dict(_flatten(weights), tlm), info)
    want = flax_to_state_dict(_flatten(jax_ckpt.average_checkpoints(
        str(jdir), num=2, val_best=val_best)), tlm)
    got = ckpt_lib.average_checkpoints(str(tdir), num=2, val_best=val_best)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k])
    argv = ["--exp_dir", str(tdir), "--dst", "avg_2", "--num", "2"]
    path = average_model.main(argv + (["--val_best"] if val_best else []))
    saved, info = ckpt_lib.load_checkpoint(path)
    assert info == {"averaged": 2, "val_best": val_best}
    assert all(torch.equal(saved[k], got[k]) for k in got)
    tlm.load_state_dict(saved, strict=True)


_UNITS = st.sampled_from(list("你好我们去学校") + ["HELLO", "world", "I'M",
                                                  " ", "  "])
_TEXT = st.lists(_UNITS, max_size=8).map("".join)


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(pairs=st.lists(st.tuples(_TEXT, _TEXT), min_size=1, max_size=5),
       char_mode=st.booleans(), case_sensitive=st.booleans())
def test_corpus_wer_matches_jax(pairs, char_mode, case_sensitive):
    refs = {f"u{i}": r for i, (r, _) in enumerate(pairs)}
    hyps = {f"u{i}": h for i, (_, h) in enumerate(pairs) if i % 4 != 3}
    outs = []
    for fn in (corpus_wer, jax_corpus_wer):
        log = io.StringIO()
        total, per = fn(refs, hyps, char_mode=char_mode,
                        case_sensitive=case_sensitive, verbose_file=log,
                        clusters=True)
        outs.append((vars(total), {k: vars(v) for k, v in per.items()},
                     total.wer, log.getvalue()))
    assert outs[0] == outs[1]


def test_use_dynamic_chunk_is_refused(tmp_path, corpus):
    """No longer refused since the streaming slice: the option builds a
    dynamic-chunk encoder, and bin.train trains it with its chunk draw
    (the trainer's dropout generator) in training only."""
    model = build_asr_model(dict(TINY_CONF, use_dynamic_chunk=True),
                            FEAT_DIM, VOCAB)
    assert model.encoder.use_dynamic_chunk
    assert not build_asr_model(dict(TINY_CONF, use_dynamic_chunk=False),
                               FEAT_DIM, VOCAB).encoder.use_dynamic_chunk
    cfg_path = str(tmp_path / "streaming.json")
    with open(cfg_path, "w") as f:
        json.dump({"model_conf": dict(TINY_CONF, use_dynamic_chunk=True,
                                      causal=True),
                   "dataset_conf": {"batch_size": 4},
                   "optim_conf": {"lr": 0.002}, "warmup_steps": 2,
                   "log_interval": 1, "seed": 3}, f)
    data = corpus["data"]
    exp = tmp_path / "exp"
    state = train.main(["--config", cfg_path, "--train_data",
                        data["manifest"], "--cv_data", data["manifest"],
                        "--dict", data["dict"], "--exp_dir", str(exp),
                        "--device", "cpu", "--max_epoch", "1"])
    with open(exp / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if r["kind"] == "train"]
    assert len(losses) == state.step > 0
    assert all(np.isfinite(x) for x in losses)
    assert (exp / "epoch_1.pt").exists()
