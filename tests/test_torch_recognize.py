"""openeat_torch.bin.recognize end to end on the CPU, and the port's
isolation from JAX.

The port's CLI (--device cpu) decodes the tests/make_tiny_data.py corpus
with the tiny Conformer from an .npz of flax leaves; the JAX model and
decode functions, given the same features batch by batch, must write
the same text in every mode, with --adaptive_steps and --length_penalty
in the attention mode, and with the host n-gram fused into rescoring.
The --timestamp_file JSONL equals the JAX CLI's on the same weights, and
both CLIs refuse --timestamp_file in the attention mode alike. With
--quantize int8 the result and timestamp files equal the JAX CLI's in
every mode. --data_type kaldi / feat decodes an ark of the corpus's
fbank as the same features decode in memory.
"""

import json
import os
import subprocess
import sys
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openeat_tpu.bin import recognize as jax_recognize
from openeat_tpu.dataset.text import load_dict, token_ids_to_text
from openeat_tpu.decode.attention_beam import adaptive_max_steps
from openeat_tpu.decode.attention_beam import recognize as attention_decode
from openeat_tpu.decode.ctc_greedy import ctc_greedy_search
from openeat_tpu.decode.ctc_prefix_beam import ctc_prefix_beam_search
from openeat_tpu.decode.rescoring import (attention_rescoring,
                                          rescoring_scores)
from openeat_tpu.lm.ngram import load_lm
from openeat_tpu.models.asr_model import ASRModel
from openeat_tpu.utils import checkpoint as jax_ckpt
from openeat_torch.bin import recognize
from openeat_torch.decode.ctc_greedy import ctc_greedy_search as torch_greedy
from openeat_torch.dataset.dataset import (AudioCollate, AudioDataset,
                                           PrefetchLoader)
from openeat_torch.ops.frontend import FrontendConfig
from openeat_torch.pipeline import DeviceFeeder
from tests._torch_parity import TINY_CONF, VOCAB, tiny_models
from tests.make_tiny_data import build as build_tiny
from tests.test_torch_kaldi_io import fbank_ark_manifest

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ["ctc_greedy_search", "ctc_prefix_beam_search",
         "attention_rescoring"]
BATCH = 4
ADAPTIVE = ["--adaptive_steps", "1", "--length_penalty", "0.5"]
NGRAM = ["--lm_weight", "0.5", "--ngram_lm", "@arpa"]


def _write_arpa(path, dict_path):
    """A bigram ARPA over the dict's tokens, log10 values from a seed."""
    toks = [t for t in load_dict(dict_path) if not t.startswith("<")]
    rng = np.random.default_rng(4)
    uni = ["<s>", "</s>", "<unk>"] + toks
    bi = [(a, b) for a in ["<s>"] + toks for b in toks + ["</s>"]
          if rng.random() < 0.3]
    lines = ["\\data\\", f"ngram 1={len(uni)}", f"ngram 2={len(bi)}", "",
             "\\1-grams:"]
    lines += [f"{-rng.uniform(0.5, 2.5):.4f}\t{w}\t{-rng.uniform(0, 1):.4f}"
              for w in uni]
    lines += ["", "\\2-grams:"]
    lines += [f"{-rng.uniform(0.1, 1.5):.4f}\t{a} {b}" for a, b in bi]
    lines += ["", "\\end\\", ""]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_recognize")
    data = build_tiny(str(root), n_utts=6, seed=3, max_dur=1.6)
    assert data["vocab_size"] <= VOCAB
    jm, variables, flat, tm = tiny_models(0)
    npz = str(root / "model.npz")
    np.savez(npz, **flat)
    pt = str(root / "model.pt")
    torch.save(tm.state_dict(), pt)
    cfg = {"model_conf": TINY_CONF, "vocab_size": VOCAB,
           "collate_conf": {"spec_aug": True}}
    cfg_path = str(root / "train.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    arpa = str(root / "lm.arpa")
    _write_arpa(arpa, data["dict"])
    jax_ckpt.save_checkpoint(str(root), "jax_ckpt", variables)
    return dict(root=root, data=data, jm=jm, variables=variables, npz=npz,
                pt=pt, cfg=cfg_path, arpa=arpa,
                jax_ckpt=str(root / "jax_ckpt"))


def _argv(s, mode, checkpoint, out, extra=()):
    return (["--config", s["cfg"], "--checkpoint", checkpoint,
             "--test_data", s["data"]["manifest"], "--dict",
             s["data"]["dict"], "--result_file", out, "--mode", mode,
             "--batch_size", str(BATCH), "--beam_size", "4",
             "--reverse_weight", "0.3"]
            + [s[a[1:]] if a.startswith("@") else a for a in extra])


def _run_port(s, mode, checkpoint, name, extra=()):
    out = str(s["root"] / f"{name}.txt")
    recognize.main(_argv(s, mode, checkpoint, out, extra)
                   + ["--device", "cpu"])
    with open(out, encoding="utf-8") as f:
        return dict(line.rstrip("\n").split(" ", 1) for line in f)


def _run_jax(s, mode, extra=()):
    """The JAX model and decode functions on the port's features."""
    char_dict = load_dict(s["data"]["dict"])
    id2tok = {v: k for k, v in char_dict.items()}
    feeder = DeviceFeeder(
        PrefetchLoader(AudioDataset(s["data"]["manifest"], char_dict,
                                    batch_size=BATCH), AudioCollate()),
        FrontendConfig(), torch.device("cpu"), pad_batch_multiple=BATCH)
    jm, v = s["jm"], s["variables"]
    encode = jax.jit(partial(jm.apply, method=ASRModel.encode))
    ctc = jax.jit(partial(jm.apply, method=ASRModel.ctc_log_probs))
    out = {}
    for keys, batch in feeder:
        enc, lens = encode(v, jnp.asarray(batch["features"].numpy()),
                           jnp.asarray(batch["features_length"].numpy()))
        lp = ctc(v, enc)
        if mode == "ctc_greedy_search":
            hyps, hyp_lens = ctc_greedy_search(lp, lens)
        elif mode == "attention":
            max_steps = min(int(enc.shape[1]), 64)
            if extra == ADAPTIVE:
                max_steps = adaptive_max_steps(ctc_greedy_search(lp, lens)[1],
                                               cap=max_steps)
            hyps, hyp_lens, _ = attention_decode(
                jm, v, enc, lens, beam_size=4, max_steps=max_steps,
                length_penalty=0.5 if extra == ADAPTIVE else 0.0)
        else:
            nbest, nlens, nscores = ctc_prefix_beam_search(lp, lens,
                                                           beam_size=4)
            if mode == "ctc_prefix_beam_search":
                hyps, hyp_lens = nbest[:, 0], nlens[:, 0]
            elif extra == NGRAM:
                scores = jax.jit(partial(rescoring_scores, jm, v,
                                         ctc_weight=0.5, reverse_weight=0.3))
                hyps, hyp_lens, _ = jax_recognize._ngram_rescore(
                    scores, enc, lens, nbest, nlens, nscores,
                    load_lm(s["arpa"]), id2tok,
                    types.SimpleNamespace(lm_weight=0.5))
            else:
                hyps, hyp_lens, _ = attention_rescoring(
                    jm, v, enc, lens, nbest, nlens, nscores,
                    ctc_weight=0.5, reverse_weight=0.3)
        hyps, hyp_lens = np.asarray(hyps), np.asarray(hyp_lens)
        for i, key in enumerate(keys):
            out[key] = token_ids_to_text(hyps[i][: hyp_lens[i]], id2tok,
                                         eos_id=VOCAB - 1)
    return out


@pytest.mark.parametrize("mode,extra", [
    *(pytest.param(m, [], id=m) for m in MODES),
    pytest.param("attention", [], id="attention"),
    pytest.param("attention", ADAPTIVE, id="attention_adaptive"),
    pytest.param("attention_rescoring", NGRAM, id="ngram_rescoring"),
])
def test_recognize_writes_the_jax_text(setup, mode, extra):
    got = _run_port(setup, mode, setup["npz"], mode + str(len(extra)),
                    extra)
    assert set(got) == set(setup["data"]["texts"])
    assert got == _run_jax(setup, mode, extra)


@pytest.mark.parametrize("mode", MODES)
def test_timestamps_equal_the_jax_cli(setup, mode):
    outs = []
    for name, main, ckpt, device in (
            ("port", recognize.main, setup["npz"], ["--device", "cpu"]),
            ("jax", jax_recognize.main, setup["jax_ckpt"], [])):
        ts = str(setup["root"] / f"ts_{name}_{mode}.jsonl")
        main(_argv(setup, mode, ckpt, str(setup["root"] / f"ts_{name}.txt"),
                   ["--timestamp_file", ts]) + device)
        with open(ts, encoding="utf-8") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]
    rows = [json.loads(line) for line in outs[0].splitlines()]
    assert {r["key"] for r in rows} == set(setup["data"]["texts"])
    assert any(r["tokens"] for r in rows)
    for r in rows:
        assert len(r["times_ms"]) == len(r["tokens"])
        assert r["times_ms"] == sorted(r["times_ms"])


def test_attention_timestamps_exit_as_jax_does(setup):
    msgs = []
    for main, ckpt, device in ((recognize.main, setup["npz"],
                                ["--device", "cpu"]),
                               (jax_recognize.main, setup["jax_ckpt"], [])):
        with pytest.raises(SystemExit) as e:
            main(_argv(setup, "attention", ckpt,
                       str(setup["root"] / "unused.txt"),
                       ["--timestamp_file", "t.jsonl"]) + device)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "attention" in msgs[0]


def test_pt_checkpoint_decodes_like_the_npz(setup):
    assert _run_port(setup, "attention_rescoring", setup["pt"], "pt") == \
        _run_port(setup, "attention_rescoring", setup["npz"], "npz")


@pytest.mark.parametrize("mode", MODES + ["attention"])
def test_int8_writes_the_jax_cli_files(setup, mode):
    """--quantize int8 --device cpu writes the JAX CLI's --quantize int8
    result file, and its timestamp file in the CTC-alignment modes."""
    outs = []
    for name, main, ckpt, device in (
            ("port", recognize.main, setup["npz"], ["--device", "cpu"]),
            ("jax", jax_recognize.main, setup["jax_ckpt"], [])):
        paths = [str(setup["root"] / f"int8_{name}_{mode}.{ext}")
                 for ext in ("txt", "jsonl")]
        ts = [] if mode == "attention" else ["--timestamp_file", paths[1]]
        main(_argv(setup, mode, ckpt, paths[0], ["--quantize", "int8", *ts])
             + device)
        outs.append([open(p, encoding="utf-8").read()
                     for p in paths[:1 + bool(ts)]])
    assert outs[0] == outs[1]
    got = dict(line.split(" ", 1) for line in outs[0][0].splitlines())
    assert set(got) == set(setup["data"]["texts"])


@pytest.mark.parametrize("extra,match", [
    (["--data_type", "kaldi"], "kaldi"),
    (["--bpe_model", "bpe.model"], "bpe"),
    (["--data_type", "feat"], "feat"),
])
def test_unported_flags_raise(setup, extra, match):
    """The flags are ported. --data_type kaldi / feat decodes an ark of
    the corpus's raw fbank as the port decodes the same features in
    memory (same batches, greedy tokens equal); a sentencepiece .model
    without sentencepiece raises ImportError, as in JAX."""
    s = setup
    if match == "bpe":
        try:
            import sentencepiece  # noqa: F401
            pytest.skip("sentencepiece is installed")
        except ImportError:
            pass
        with pytest.raises(ImportError, match=match):
            _run_port(s, "ctc_greedy_search", s["npz"], "bpe", extra)
        return
    char_dict = load_dict(s["data"]["dict"])
    manifest, feats = fbank_ark_manifest(s["data"]["manifest"], char_dict,
                                         str(s["root"] / f"ark_{match}"))
    out = str(s["root"] / f"{match}.txt")
    argv = _argv(s, "ctc_greedy_search", s["npz"], out, extra)
    argv[argv.index("--test_data") + 1] = manifest
    recognize.main(argv + ["--device", "cpu"])
    got = dict(line.rstrip("\n").split(" ", 1)
               for line in open(out, encoding="utf-8"))
    model = recognize.load_model(json.load(open(s["cfg"])), s["pt"], VOCAB,
                                 torch.device("cpu"))
    fe = FrontendConfig.from_collate_conf({"spec_aug": True})
    feeder = DeviceFeeder(PrefetchLoader(
        AudioDataset(manifest, char_dict, batch_size=BATCH, data_type="feat"),
        AudioCollate()), fe.without_augmentation(), torch.device("cpu"),
        pad_batch_multiple=BATCH)
    id2tok = {v: k for k, v in char_dict.items()}
    want = {}
    with torch.inference_mode():
        for keys, batch in feeder:
            enc, lens = model.encode(batch["features"],
                                     batch["features_length"])
            hyps, hyp_lens = torch_greedy(model.ctc_log_probs(enc), lens)
            for i, k in enumerate(keys):
                want[k] = token_ids_to_text(hyps[i][: hyp_lens[i]].tolist(),
                                            id2tok, eos_id=model.eos)
    assert set(got) == set(want) == set(feats) == set(s["data"]["texts"])
    assert {k: v.strip() for k, v in got.items()} == want


def test_cuda_without_a_card_raises(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        recognize.main(["--config", setup["cfg"], "--checkpoint",
                        setup["npz"], "--test_data",
                        setup["data"]["manifest"], "--dict",
                        setup["data"]["dict"], "--result_file",
                        str(setup["root"] / "cuda.txt")])


PORT_MODULES = [
    "openeat_torch.bin.train", "openeat_torch.ops.ctc_loss",
    "openeat_torch.ops.depthwise_conv", "openeat_torch.modules.dropout",
    "openeat_torch.modules.label_smoothing",
    "openeat_torch.parallel.train_step", "openeat_torch.utils.checkpoint",
    "openeat_torch.utils.executor", "openeat_torch.utils.optim",
    "openeat_torch.utils.scheduler", "openeat_torch.bin.train_lm",
    "openeat_torch.bin.average_model", "openeat_torch.decode.attention_beam",
    "openeat_torch.models.language_model", "openeat_torch.lm.ngram",
    "openeat_torch.utils.wer", "openeat_torch.decode.endpoint",
    "openeat_torch.decode.streaming", "openeat_torch.decode.streaming_batch",
    "openeat_torch.bin.stream_recognize", "openeat_torch.runtime.server",
    "openeat_torch.runtime.client", "openeat_torch.bin.serve",
    "openeat_torch.utils.quantize", "openeat_torch.parallel.mesh",
    "openeat_torch.parallel.tensor_parallel"]


def test_port_imports_no_jax():
    """Every openeat_torch module (the training, attention decode, LM,
    recipe, streaming, serving, int8 and parallel slices' among them)
    and the chip scripts (chip_smoke.py, chip_kernel_bench.py,
    chip_wgrad_probe.py) import with jax blocked, and no jax, flax, optax,
    orbax or openeat_tpu module loads."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import openeat_torch\n"
        "for m in pkgutil.walk_packages(openeat_torch.__path__, "
        "'openeat_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, chip_kernel_bench, chip_wgrad_probe\n"
        f"missing = set({PORT_MODULES!r}) - set(sys.modules)\n"
        "assert not missing, missing\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'openeat_tpu') "
        "and sys.modules[k] is not None)\n"
        "print('LOADED', bad)\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout
