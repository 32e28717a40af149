"""The LibriSpeech recipe's slice on the port against the JAX package,
at a small size on the CPU.

examples/librispeech's path cut to 2 encoder blocks and d 64, with its
kernel 31 conv module, FFN 4 x d, rel_pos, conv2d x4, 1+1 decoders and
reverse_weight 0.3: a seeded English corpus written as FLAC by the
port's encoder (wav.scp entries end in .flac; one is a `path,start,end`
segment), BPE trained by openeat_torch.bin.train_bpe, the dict from the
port's tokenize. The checks:
- the port's collate (native reader) gives the JAX collate's waveform
  and BPE target batch exactly;
- on that batch's features (the port's frontend) the float32 loss,
  loss_ctc and loss_att equal the JAX model's within 1e-5 relative and
  every gradient is within 1e-4 of its tensor's max |grad| plus 1e-7 of
  the model's largest (tests/test_torch_train_step.py's bound);
- openeat_torch.bin.recognize --bpe_model on the FLAC manifest writes
  the JAX CLI's text in ctc_greedy_search and attention_rescoring,
  word-joined (no `▁`), and utils/wer.py scores it as JAX's does.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openeat_tpu.bin import recognize as jax_recognize
from openeat_tpu.dataset.dataset import AudioCollate as JaxCollate
from openeat_tpu.dataset.dataset import AudioDataset as JaxDataset
from openeat_tpu.dataset.bpe import load_bpe as jax_load_bpe
from openeat_tpu.models.asr_model import build_asr_model as build_jax_model
from openeat_tpu.utils import checkpoint as jax_ckpt
from openeat_tpu.utils.checkpoint import _flatten
from openeat_tpu.utils.wer import corpus_wer as jax_corpus_wer
from openeat_torch.bin import recognize, train_bpe
from openeat_torch.dataset.bpe import load_bpe
from openeat_torch.dataset.dataset import AudioCollate, AudioDataset
from openeat_torch.dataset.flac import write_flac
from openeat_torch.dataset.text import load_dict, remove_punctuation, tokenize
from openeat_torch.models.asr_model import build_asr_model
from openeat_torch.ops.frontend import FrontendConfig, compute_features
from openeat_torch.utils.param_bridge import flax_to_state_dict
from openeat_torch.utils.wer import corpus_wer
from tests._torch_parity import _draw
from tests.test_torch_bpe import english_lines

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = dict(d_model=64, attention_heads=4, linear_units=256,
            encoder_num_blocks=2, decoder_num_blocks=1,
            r_decoder_num_blocks=1, cnn_module_kernel=31,
            input_layer="conv2d", pos_enc_layer_type="rel_pos",
            macaron_style=True, use_cnn_module=True, reverse_weight=0.3,
            ctc_weight=0.3, lsm_weight=0.1, dropout_rate=0.0,
            compute_dtype="float32")
N_UTTS = 6


def _write_corpus(root, rng):
    lines = english_lines(rng, N_UTTS, n_words=60, max_words=6)
    entries, texts = [], {}
    for i, text in enumerate(lines):
        dur = 0.8 + 0.2 * len(text.split())
        t = np.arange(int(dur * 16000)) / 16000.0
        x = sum(0.1 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t)
                for _ in range(3)) + 0.02 * rng.standard_normal(t.size)
        path = str(root / f"u{i}.flac")
        write_flac(path, x.astype(np.float32), 16000)
        if i == 0:     # a segment of the file, as a wav.scp may give one
            path, dur = f"{path},0.1,{dur - 0.1:.3f}", dur - 0.2
        entries.append(f"utt:u{i}\tfeat:{path}\tfeat_shape:{dur:.3f}\t"
                       f"text:{text}\n")
        texts[f"u{i}"] = text
    manifest = root / "format.data"
    manifest.write_text("".join(entries), encoding="utf-8")
    (root / "text").write_text("".join(f"{k} {v}\n"
                                       for k, v in texts.items()),
                               encoding="utf-8")
    return str(manifest), texts


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_librispeech")
    manifest, texts = _write_corpus(root, np.random.default_rng(31))
    bpe_path = train_bpe.main(["--input", str(root / "text"),
                               "--skip_ncols", "1", "--model_prefix",
                               str(root / "bpe"), "--vocab_size", "80"])
    bpe = load_bpe(bpe_path)
    pieces = sorted({p for t in texts.values()
                     for p in tokenize(remove_punctuation(t), bpe)})
    vocab = ["<blank>", "<unk>"] + pieces + ["<sos/eos>"]
    dict_path = root / "dict.txt"
    dict_path.write_text("".join(f"{t} {i}\n" for i, t in enumerate(vocab)),
                         encoding="utf-8")
    # the JAX model's tree, every leaf drawn with numpy, bridged
    jm = build_jax_model(CONF, 80, len(vocab))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 40, 80)), jnp.array([40]),
                            jnp.ones((1, 4), jnp.int32), jnp.array([4]))
    rng = np.random.default_rng(5)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(_draw(rng, path[-1].key,
                                             leaf.shape)), shapes)
    tm = build_asr_model(CONF, 80, len(vocab))
    tm.load_state_dict(flax_to_state_dict(_flatten(variables), tm))
    cfg = {"model_conf": CONF, "vocab_size": len(vocab), "input_size": 80,
           "collate_conf": {"spec_aug": True}}
    cfg_path = root / "train.json"
    cfg_path.write_text(json.dumps(cfg))
    pt = str(root / "model.pt")
    torch.save(tm.state_dict(), pt)
    jax_ckpt.save_checkpoint(str(root), "jax_ckpt", variables)
    return dict(root=root, manifest=manifest, texts=texts, bpe=bpe_path,
                dict=str(dict_path), vocab=vocab, jm=jm,
                variables=variables, tm=tm, cfg=str(cfg_path), pt=pt,
                jax_ckpt=str(root / "jax_ckpt"))


def test_bpe_corpus_batch_loss_and_gradients_equal_jax(setup):
    s = setup
    char_dict = load_dict(s["dict"])
    kw = dict(batch_type="static", batch_size=N_UTTS, max_length=100000)
    collate = AudioCollate()
    assert collate.native_io is True
    keys, host = collate(AudioDataset(s["manifest"], char_dict,
                                      load_bpe(s["bpe"]), **kw)[0])
    jkeys, jhost = JaxCollate(use_native_io=False)(JaxDataset(
        s["manifest"], char_dict, jax_load_bpe(s["bpe"]), **kw)[0])
    assert keys == jkeys
    for k in ("wav", "wav_lens", "targets", "targets_length"):
        np.testing.assert_array_equal(host[k], jhost[k])
    assert (host["targets"] > 1).sum() == host["targets_length"].sum()

    feats, flens = compute_features(torch.from_numpy(host["wav"]),
                                    torch.from_numpy(host["wav_lens"]),
                                    FrontendConfig())
    ys = torch.from_numpy(host["targets"]).long()
    ys_lens = torch.from_numpy(host["targets_length"]).long()
    jm, variables, tm = s["jm"], s["variables"], s["tm"]

    def loss_fn(v):
        m = jm.apply(v, jnp.asarray(feats.numpy()), jnp.asarray(
            flens.numpy()), jnp.asarray(host["targets"]),
            jnp.asarray(host["targets_length"]))
        return m["loss"], m

    (_, j_metrics), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables)
    tm.train()
    tm.zero_grad()
    metrics = tm(feats, flens, ys, ys_lens)
    metrics["loss"].backward()
    for key in ("loss", "loss_ctc", "loss_att"):
        np.testing.assert_allclose(float(metrics[key].detach()),
                                   float(j_metrics[key]), rtol=1e-5,
                                   err_msg=key)
    want = flax_to_state_dict(_flatten(j_grads), tm)
    g_max = max(float(g.abs().max()) for g in want.values())
    for name, p in tm.named_parameters():
        ref = want[name].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max() + 1e-7 * g_max, (name, err)
    assert tm.encoder.encoders.layer_0.conv_module.depthwise_conv.weight \
        .shape[0] == 31


@pytest.mark.parametrize("mode", ["ctc_greedy_search",
                                  "attention_rescoring"])
def test_recognize_with_bpe_writes_the_jax_text(setup, mode):
    s = setup
    outs = {}
    for name, main, ckpt, extra in (
            ("port", recognize.main, s["pt"], ["--device", "cpu"]),
            ("jax", jax_recognize.main, s["jax_ckpt"], [])):
        out = str(s["root"] / f"{name}_{mode}.txt")
        main(["--config", s["cfg"], "--checkpoint", ckpt, "--test_data",
              s["manifest"], "--dict", s["dict"], "--bpe_model", s["bpe"],
              "--result_file", out, "--mode", mode, "--batch_size", "4",
              "--beam_size", "4", "--reverse_weight", "0.3", *extra])
        outs[name] = dict((line.rstrip("\n").split(" ", 1) + [""])[:2]
                          for line in open(out, encoding="utf-8"))
    assert outs["port"] == outs["jax"]
    assert set(outs["port"]) == set(s["texts"])
    assert not any("▁" in v for v in outs["port"].values())
    assert any(outs["port"].values())
    got = corpus_wer(s["texts"], outs["port"], char_mode=False)
    want = jax_corpus_wer(s["texts"], outs["jax"], char_mode=False)
    assert got.wer == want.wer


def test_chip_smoke_trains_the_recipe_config():
    """chip_smoke.py's LibriSpeech config is examples/librispeech/conf/
    train_conformer.yaml (the card has no PyYAML) with only the cuts its
    docstring names: max_epoch, log_interval and the run's seed."""
    import yaml

    import chip_smoke
    with open(os.path.join(REPO, "examples", "librispeech", "conf",
                           "train_conformer.yaml")) as f:
        recipe = yaml.safe_load(f)
    got = dict(chip_smoke.LS_TRAIN_CONFIG)
    cuts = {k: got.pop(k) for k in ("max_epoch", "log_interval", "seed")}
    assert cuts["max_epoch"] < recipe.pop("max_epoch")
    recipe.pop("log_interval")
    assert got == recipe
    assert got["model_conf"]["cnn_module_kernel"] == 31
