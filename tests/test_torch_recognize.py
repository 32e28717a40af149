"""openeat_torch.bin.recognize end to end on the CPU, and the port's
isolation from JAX.

The port's CLI (--device cpu) decodes the tests/make_tiny_data.py corpus
with the tiny Conformer from an .npz of flax leaves; the JAX model and
decode functions, given the same features batch by batch, must write
the same text in every mode.
"""

import json
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openeat_tpu.dataset.text import load_dict, token_ids_to_text
from openeat_tpu.decode.ctc_greedy import ctc_greedy_search
from openeat_tpu.decode.ctc_prefix_beam import ctc_prefix_beam_search
from openeat_tpu.decode.rescoring import attention_rescoring
from openeat_tpu.models.asr_model import ASRModel
from openeat_torch.bin import recognize
from openeat_torch.dataset.dataset import (AudioCollate, AudioDataset,
                                           PrefetchLoader)
from openeat_torch.ops.frontend import FrontendConfig
from openeat_torch.pipeline import DeviceFeeder
from tests._torch_parity import TINY_CONF, VOCAB, tiny_models
from tests.make_tiny_data import build as build_tiny

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ["ctc_greedy_search", "ctc_prefix_beam_search",
         "attention_rescoring"]
BATCH = 4


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
    return dict(root=root, data=data, jm=jm, variables=variables, npz=npz,
                pt=pt, cfg=cfg_path)


def _run_port(s, mode, checkpoint, name):
    out = str(s["root"] / f"{name}.txt")
    recognize.main(["--config", s["cfg"], "--checkpoint", checkpoint,
                    "--test_data", s["data"]["manifest"], "--dict",
                    s["data"]["dict"], "--result_file", out, "--mode", mode,
                    "--batch_size", str(BATCH), "--beam_size", "4",
                    "--reverse_weight", "0.3", "--device", "cpu"])
    with open(out, encoding="utf-8") as f:
        return dict(line.rstrip("\n").split(" ", 1) for line in f)


def _run_jax(s, mode):
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
        else:
            nbest, nlens, nscores = ctc_prefix_beam_search(lp, lens,
                                                           beam_size=4)
            if mode == "ctc_prefix_beam_search":
                hyps, hyp_lens = nbest[:, 0], nlens[:, 0]
            else:
                hyps, hyp_lens, _ = attention_rescoring(
                    jm, v, enc, lens, nbest, nlens, nscores,
                    ctc_weight=0.5, reverse_weight=0.3)
        hyps, hyp_lens = np.asarray(hyps), np.asarray(hyp_lens)
        for i, key in enumerate(keys):
            out[key] = token_ids_to_text(hyps[i][: hyp_lens[i]], id2tok,
                                         eos_id=VOCAB - 1)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_recognize_writes_the_jax_text(setup, mode):
    got = _run_port(setup, mode, setup["npz"], mode)
    assert set(got) == set(setup["data"]["texts"])
    assert got == _run_jax(setup, mode)


def test_pt_checkpoint_decodes_like_the_npz(setup):
    assert _run_port(setup, "attention_rescoring", setup["pt"], "pt") == \
        _run_port(setup, "attention_rescoring", setup["npz"], "npz")


@pytest.mark.parametrize("extra,match", [
    (["--mode", "attention"], "attention"),
    (["--quantize", "int8"], "int8"),
    (["--timestamp_file", "t.jsonl"], "timestamp"),
    (["--dp", "2"], "--dp"),
    (["--lm_weight", "0.5", "--ngram_lm", "lm.arpa"], "LM"),
    (["--bpe_model", "bpe.model"], "bpe"),
    (["--data_type", "feat"], "feat"),
])
def test_unported_flags_raise(setup, extra, match):
    with pytest.raises(NotImplementedError, match=match):
        recognize.main(["--config", setup["cfg"], "--checkpoint",
                        setup["npz"], "--test_data", "unused", "--dict",
                        "unused", "--result_file", "unused",
                        "--device", "cpu"] + extra)


def test_cuda_without_a_card_raises(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        recognize.main(["--config", setup["cfg"], "--checkpoint",
                        setup["npz"], "--test_data",
                        setup["data"]["manifest"], "--dict",
                        setup["data"]["dict"], "--result_file",
                        str(setup["root"] / "cuda.txt")])


TRAINING_MODULES = [
    "openeat_torch.bin.train", "openeat_torch.ops.ctc_loss",
    "openeat_torch.ops.depthwise_conv", "openeat_torch.modules.dropout",
    "openeat_torch.modules.label_smoothing",
    "openeat_torch.parallel.train_step", "openeat_torch.utils.checkpoint",
    "openeat_torch.utils.executor", "openeat_torch.utils.optim",
    "openeat_torch.utils.scheduler"]


def test_port_imports_no_jax():
    """Every openeat_torch module (the training slice's among them) and
    chip_smoke.py import with jax blocked, and no jax, flax, optax, orbax
    or openeat_tpu module loads."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import openeat_torch\n"
        "for m in pkgutil.walk_packages(openeat_torch.__path__, "
        "'openeat_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"missing = set({TRAINING_MODULES!r}) - set(sys.modules)\n"
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
