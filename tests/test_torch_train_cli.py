"""openeat_torch.bin.train end to end on the CPU (--device cpu).

On the tests/make_tiny_data.py corpus with the tiny Conformer (dynamic
batches, SpecAugment, spec-sub, feature dither and dropout on): two
epochs write epoch_1/2.pt, their .json info, optimizer.pt, train.json
and metrics.jsonl with finite losses; resuming from epoch_1.pt restores
the optimizer and continues the step count, and with the same seeds
reproduces the uninterrupted run's second epoch; recognize decodes from
epoch_2.pt and train.json. --data_type feat trains on an ark of the
corpus's fbank, and a sentencepiece --bpe_model without sentencepiece
raises ImportError, as in JAX.
"""

import json
import os

import numpy as np
import pytest
import torch

from openeat_torch.bin import recognize, train
from openeat_torch.dataset.text import load_dict
from tests._torch_parity import TINY_CONF
from tests.make_tiny_data import build as build_tiny
from tests.test_torch_kaldi_io import fbank_ark_manifest

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train")
    data = build_tiny(str(root), n_utts=8, seed=5, max_dur=1.4)
    cfg = {"model_conf": dict(TINY_CONF, dropout_rate=0.1),
           "collate_conf": {"spec_aug": True, "spec_sub": True,
                            "feature_dither": 0.1,
                            "spec_aug_conf": {"num_t_mask": 3}},
           "dataset_conf": {"batch_type": "dynamic",
                            "max_frames_in_batch": 400},
           "optim_conf": {"lr": 0.002}, "warmup_steps": 4,
           "log_interval": 1, "seed": 11}
    cfg_path = str(root / "train.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    return dict(root=root, data=data, cfg=cfg_path)


def _train(c, exp, extra=()):
    return train.main(["--config", c["cfg"], "--train_data",
                       c["data"]["manifest"], "--cv_data",
                       c["data"]["manifest"], "--exp_dir", str(exp),
                       "--dict", c["data"]["dict"], "--device", "cpu",
                       "--num_workers", "1", *extra])


def _records(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_resume_and_decode(corpus):
    exp = corpus["root"] / "exp"
    state = _train(corpus, exp, ["--max_epoch", "2"])
    for name in ("epoch_1.pt", "epoch_1.json", "epoch_2.pt", "epoch_2.json",
                 "optimizer.pt", "train.json", "metrics.jsonl", "train.log"):
        assert (exp / name).exists(), name
    steps = [r for r in _records(exp) if r["kind"] == "train"]
    assert len(steps) == state.step > 0
    assert all(r["loss"] == r["loss"] and abs(r["loss"]) < 1e9
               for r in steps)
    info1 = json.loads((exp / "epoch_1.json").read_text())
    info2 = json.loads((exp / "epoch_2.json").read_text())
    assert info2["step"] == state.step == 2 * info1["step"]
    resolved = json.loads((exp / "train.json").read_text())
    assert resolved["vocab_size"] == len(load_dict(corpus["data"]["dict"]))

    # one epoch, then a resume from its epoch_1.pt: the second epoch is
    # the uninterrupted run's (the rolling optimizer.pt is epoch 1's)
    exp_r = corpus["root"] / "exp_resume"
    _train(corpus, exp_r, ["--max_epoch", "1"])
    resumed = _train(corpus, exp_r, ["--max_epoch", "2", "--checkpoint",
                                     str(exp_r / "epoch_1.pt")])
    assert resumed.step == state.step
    assert resumed.n_applied == state.n_applied
    ref = torch.load(exp / "epoch_2.pt", weights_only=True)
    got = torch.load(exp_r / "epoch_2.pt", weights_only=True)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=1e-5, atol=1e-6)

    out = str(corpus["root"] / "hyp.txt")
    recognize.main(["--config", str(exp / "train.json"), "--checkpoint",
                    str(exp / "epoch_2.pt"), "--test_data",
                    corpus["data"]["manifest"], "--dict",
                    corpus["data"]["dict"], "--result_file", out, "--mode",
                    "ctc_greedy_search", "--batch_size", "4", "--device",
                    "cpu"])
    with open(out, encoding="utf-8") as f:
        keys = {line.split(" ", 1)[0].strip() for line in f}
    assert keys == set(corpus["data"]["texts"])


@pytest.mark.parametrize("extra,cfg_extra,match", [
    (["--bpe_model", "bpe.model"], {}, "bpe"),
    (["--data_type", "feat"], {}, "feat"),
])
def test_unported_flags_raise(corpus, tmp_path, extra, cfg_extra, match):
    """The flags are ported. --data_type feat trains an epoch on an ark
    of the corpus's fbank (finite losses, input_size the features' dim
    in train.json); a sentencepiece .model without sentencepiece raises
    ImportError, as the JAX trainer's load_bpe does."""
    cfg = dict(json.loads(open(corpus["cfg"]).read()), **cfg_extra)
    cfg_path = str(tmp_path / "c.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    data = corpus["data"]["manifest"]
    if match == "feat":
        data, _ = fbank_ark_manifest(data, load_dict(corpus["data"]["dict"]),
                                     str(tmp_path / "fbank"))
    argv = ["--config", cfg_path, "--train_data", data, "--cv_data", data,
            "--exp_dir", str(tmp_path / "exp"), "--dict",
            corpus["data"]["dict"], "--device", "cpu", "--max_epoch", "1",
            "--num_workers", "1", *extra]
    if match == "bpe":
        try:
            import sentencepiece  # noqa: F401
            pytest.skip("sentencepiece is installed")
        except ImportError:
            pass
        with pytest.raises(ImportError, match=match):
            train.main(argv)
        return
    state = train.main(argv)
    steps = [r for r in _records(tmp_path / "exp") if r["kind"] == "train"]
    assert len(steps) == state.step > 0
    assert all(np.isfinite(r["loss"]) for r in steps)
    resolved = json.loads((tmp_path / "exp" / "train.json").read_text())
    assert resolved["input_size"] == 80


def test_cuda_without_a_card_raises(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--config", corpus["cfg"], "--train_data",
                    corpus["data"]["manifest"], "--cv_data",
                    corpus["data"]["manifest"], "--exp_dir",
                    str(tmp_path / "exp"), "--dict", corpus["data"]["dict"]])
