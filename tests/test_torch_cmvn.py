"""openeat_torch's global CMVN against the JAX package's, on the CPU.

- load_cmvn on a WeNet JSON file and on a kaldi text file equals
  openeat_tpu/utils/cmvn.py's, bit for bit;
- one train step of the tiny Conformer (tests/_torch_parity.py, float32,
  dropout 0) built with GlobalCMVN, its statistics from that file, the
  clip active (norm above 5): loss within 1e-5 relative, the norm, which
  counts the statistics' gradients as JAX's flat norm over the whole
  tree does, within 1e-4, the updated parameters within
  tests/test_torch_train_step.py's tolerances (SGD 1e-6, which pins the
  clip scale; Adam 2 lr, and lr / 100 where the gradient is not
  rounding noise), the statistics unchanged on both sides;
- bin.train: collate_conf.normalization true with --cmvn_file raises
  ValueError; a --cmvn_file run records use_global_cmvn true and
  normalization false in train.json and its checkpoint carries the
  file's statistics; a resume from that checkpoint without the flag
  builds the same model, keeps the statistics and continues the step
  count.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openeat_tpu.modules.cmvn import cmvn_params
from openeat_tpu.parallel.train_step import TrainState as JaxTrainState
from openeat_tpu.parallel.train_step import \
    build_train_step as jax_build_train_step
from openeat_tpu.utils.checkpoint import _flatten
from openeat_tpu.utils.cmvn import load_cmvn as jax_load_cmvn
from openeat_tpu.utils.optim import build_optimizer as jax_build_optimizer
from openeat_torch.bin import train
from openeat_torch.parallel.train_step import TrainState, build_train_step
from openeat_torch.utils.cmvn import load_cmvn
from openeat_torch.utils.optim import build_optimizer
from openeat_torch.utils.param_bridge import flax_to_state_dict
from tests._torch_parity import FEAT_DIM, TINY_CONF, VOCAB, tiny_models
from tests.make_tiny_data import build as build_tiny

torch.set_num_threads(1)


def _stats(seed: int, dim: int = FEAT_DIM, frames: int = 700):
    """Sum, sum of squares and count of log-mel-like frames."""
    x = np.random.default_rng(seed).normal(8.0, 3.0, (frames, dim))
    return x.sum(0), (x * x).sum(0), frames


def write_json_cmvn(path: str, seed: int = 0) -> str:
    m, v, n = _stats(seed)
    with open(path, "w") as f:
        json.dump({"mean_stat": m.tolist(), "var_stat": v.tolist(),
                   "frame_num": n}, f)
    return path


def write_kaldi_cmvn(path: str, seed: int = 0) -> str:
    m, v, n = _stats(seed)
    with open(path, "w") as f:
        f.write(" [\n  " + " ".join(f"{x:.6f}" for x in m) + f" {n}\n  "
                + " ".join(f"{x:.6f}" for x in v) + " 0 ]\n")
    return path


@pytest.mark.parametrize("is_json", [True, False], ids=["json", "kaldi"])
def test_load_cmvn_equals_jax(tmp_path, is_json):
    path = (write_json_cmvn if is_json else write_kaldi_cmvn)(
        str(tmp_path / "cmvn"), 3)
    mean, istd = load_cmvn(path, is_json)
    j_mean, j_istd = jax_load_cmvn(path, is_json)
    assert mean.dtype == istd.dtype == np.float32
    np.testing.assert_array_equal(mean, j_mean)
    np.testing.assert_array_equal(istd, j_istd)
    assert 5.0 < float(mean.mean()) < 11.0 and 0.2 < float(istd.mean()) < 0.5


def _batch(seed=2, b=3, t=57):
    """Raw log-mel-like features (CMVN's input), one infeasible CTC row."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(8.0, 3.0, (b, t, FEAT_DIM)).astype(np.float32)
    ys = rng.integers(1, VOCAB - 1, (b, 8)).astype(np.int32)
    ys_lens = np.array([8, 3, 6][:b], np.int32)
    for i, n in enumerate(ys_lens):
        ys[i, n:] = -1
    return {"features": feats,
            "features_length": np.array([t, t - 16, 23][:b], np.int32),
            "targets": ys, "targets_length": ys_lens}


@pytest.mark.parametrize("optim", ["sgd", "adam"])
def test_global_cmvn_step_with_the_clip_matches_jax(tmp_path, optim):
    mean, istd = load_cmvn(write_json_cmvn(str(tmp_path / "c.json")), True)
    jm, variables, _, tm = tiny_models(0, use_global_cmvn=True,
                                       dropout_rate=0.0)
    variables = jax.tree.map(lambda x: x, variables)
    variables["params"]["encoder"]["global_cmvn"] = cmvn_params(mean, istd)
    with torch.no_grad():
        tm.encoder.global_cmvn.mean.copy_(torch.from_numpy(mean))
        tm.encoder.global_cmvn.istd.copy_(torch.from_numpy(istd))
    lr = 1e-3
    tx, _ = jax_build_optimizer(lr, 3, optim, variables)
    j_state = JaxTrainState(variables, tx.init(variables),
                            jnp.zeros((), jnp.int32))
    batch = _batch()
    j_state, j_metrics = jax.jit(jax_build_train_step(
        jm, tx, 1, 5.0, donate=False))(
        j_state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    j_grads = flax_to_state_dict(_flatten(jax.grad(
        lambda v: jm.apply(v, *(jnp.asarray(x) for x in batch.values()))[
            "loss"])(variables)), tm)

    opt, schedule = build_optimizer(tm, lr, 3, optim)
    assert not any(p is tm.encoder.global_cmvn.mean
                   for g in opt.param_groups for p in g["params"])
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    metrics = build_train_step(schedule, 1, 5.0)(
        TrainState(tm, opt),
        {k: torch.from_numpy(v) for k, v in batch.items()}, None)

    np.testing.assert_allclose(float(metrics["loss"]),
                               float(j_metrics["loss"]), rtol=1e-5)
    norm = float(metrics["grad_norm"])
    np.testing.assert_allclose(norm, float(j_metrics["grad_norm"]),
                               rtol=1e-4)
    assert norm > 5.0   # the clip acts
    # the statistics' gradients are part of the norm
    without = float(torch.sqrt(sum(g.double().square().sum()
                                   for n, g in j_grads.items()
                                   if "global_cmvn" not in n)))
    assert without < norm * (1 - 1e-3), (without, norm)
    want = flax_to_state_dict(_flatten(j_state.params), tm)
    g_max = max(float(g.abs().max()) for g in j_grads.values())
    for name, p in tm.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        diff = np.abs(got - ref)
        if "global_cmvn" in name:
            np.testing.assert_array_equal(got, before[name].numpy())
            np.testing.assert_array_equal(ref, before[name].numpy())
        elif optim == "sgd":
            assert diff.max() <= 1e-6 * (1 + np.abs(ref).max()), name
        else:
            assert diff.max() <= 2 * lr, (name, diff.max())
            g = j_grads[name].abs().numpy()
            sure = (g >= 1e-3 * g.max()) & (g >= 1e-7 * g_max)
            if sure.any():
                assert diff[sure].max() <= lr / 100, (name, diff[sure].max())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cmvn")
    data = build_tiny(str(root), n_utts=6, seed=8, max_dur=1.2)
    cfg = {"model_conf": dict(TINY_CONF, dropout_rate=0.1),
           "collate_conf": {"spec_aug": True},
           "dataset_conf": {"batch_type": "dynamic",
                            "max_frames_in_batch": 400},
           "optim_conf": {"lr": 0.002}, "warmup_steps": 2,
           "log_interval": 1, "seed": 5}
    cfg_path = str(root / "train.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    return dict(root=root, data=data, cfg=cfg, cfg_path=cfg_path,
                cmvn=write_kaldi_cmvn(str(root / "cmvn.ark"), 1))


def _train(c, exp, cfg_path=None, extra=()):
    return train.main(["--config", cfg_path or c["cfg_path"],
                       "--train_data", c["data"]["manifest"], "--cv_data",
                       c["data"]["manifest"], "--exp_dir", str(exp),
                       "--dict", c["data"]["dict"], "--device", "cpu",
                       "--num_workers", "1", *extra])


def test_normalization_true_with_cmvn_file_raises(corpus, tmp_path):
    cfg = dict(corpus["cfg"], collate_conf={"normalization": True})
    path = str(tmp_path / "norm.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(ValueError, match="normalization"):
        _train(corpus, tmp_path / "exp", path,
               ["--cmvn_file", corpus["cmvn"], "--is_json_cmvn", "false",
                "--max_epoch", "1"])


def test_cmvn_file_run_and_its_checkpoint_resume(corpus):
    exp = corpus["root"] / "exp"
    state = _train(corpus, exp, extra=["--cmvn_file", corpus["cmvn"],
                                       "--is_json_cmvn", "false",
                                       "--max_epoch", "1"])
    resolved = json.loads((exp / "train.json").read_text())
    assert resolved["use_global_cmvn"] is True
    assert resolved["collate_conf"]["normalization"] is False
    mean, istd = load_cmvn(corpus["cmvn"], False)
    ckpt = torch.load(exp / "epoch_1.pt", weights_only=True)
    np.testing.assert_array_equal(ckpt["encoder.global_cmvn.mean"], mean)
    np.testing.assert_array_equal(ckpt["encoder.global_cmvn.istd"], istd)
    # a resume from the checkpoint alone: GlobalCMVN from its statistics
    resumed = _train(corpus, exp, extra=["--checkpoint",
                                         str(exp / "epoch_1.pt"),
                                         "--max_epoch", "2"])
    assert resumed.step == 2 * state.step > 0
    cmvn = resumed.model.encoder.global_cmvn
    np.testing.assert_array_equal(cmvn.mean.detach().numpy(), mean)
    np.testing.assert_array_equal(cmvn.istd.detach().numpy(), istd)
    assert json.loads((exp / "train.json").read_text())[
        "use_global_cmvn"] is True
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        losses = [json.loads(x)["loss"] for x in f
                  if json.loads(x)["kind"] == "train"]
    assert len(losses) == resumed.step and all(np.isfinite(losses))
