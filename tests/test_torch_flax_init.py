"""The JAX package's initial weights in the port.

`flax_init` builds a config's model in both packages, draws the
flax parameters exactly as openeat_tpu/bin/train.py does
(`init_params(model, example_batch, seed)`, jitted `model.init` at
`PRNGKey(seed)`), and converts them with the weight bridge; every key
of the port's model must be filled. Run as a script it writes the
result as an epoch-0 checkpoint, from which `openeat_torch.bin.train
--checkpoint` starts a run at epoch 0 and step 0 with a fresh
optimizer:

    JAX_PLATFORMS=cpu python -m tests.test_torch_flax_init \
        benchmarks/results/r5_recipe_lmhard/train.yaml OUT_DIR [--seed 777]

writes OUT_DIR/epoch_0.pt and OUT_DIR/epoch_0.json ({"epoch": 0,
"step": 0}) and prints the line `openeat_torch.quality.init_draw`
prints for the port's own draw: the path, the seed, the tensor and
parameter counts and the state dict's sha256 (`state_sha256`). The
tests below check the same at a small width.
"""

from __future__ import annotations

import argparse
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from openeat_tpu.config import load_config
from openeat_tpu.models.asr_model import build_asr_model as build_jax_model
from openeat_tpu.parallel.train_step import init_params
from openeat_tpu.utils.checkpoint import _flatten
from openeat_torch.bin import train
from openeat_torch.dataset.text import load_dict
from openeat_torch.models.asr_model import \
    build_asr_model as build_torch_model
from openeat_torch.quality.init_draw import state_sha256
from openeat_torch.utils import checkpoint as ckpt_lib
from openeat_torch.utils.param_bridge import flax_to_state_dict
from tests.make_tiny_data import build as build_tiny


def _example_batch(input_size: int) -> dict:
    """A batch of the shapes init needs; the parameters do not depend
    on its values or its lengths."""
    return {"features": jnp.zeros((2, 64, input_size), jnp.float32),
            "features_length": jnp.array([64, 48], jnp.int32),
            "targets": jnp.ones((2, 5), jnp.int32),
            "targets_length": jnp.array([5, 3], jnp.int32)}


def flax_init(cfg: dict, seed: int = 777):
    """(the port's state_dict of flax's initial weights, the port model,
    the flax model, its parameters) for the resolved config `cfg`
    (input_size, vocab_size and use_global_cmvn set, as a trainer's
    train.yaml has them)."""
    conf = dict(cfg.get("model_conf", {}) or {})
    size, vocab = cfg["input_size"], cfg["vocab_size"]
    cmvn = bool(cfg.get("use_global_cmvn", False))
    jmodel = build_jax_model(conf, size, vocab, use_global_cmvn=cmvn)
    params = init_params(jmodel, _example_batch(size), seed)
    tmodel = build_torch_model(conf, size, vocab, use_global_cmvn=cmvn)
    state = flax_to_state_dict(_flatten(params), tmodel)
    missing = sorted(set(tmodel.state_dict()) - set(state))
    if missing:
        raise KeyError(f"flax init leaves {missing[:8]} unfilled")
    return state, tmodel, jmodel, params


def write_epoch0(cfg: dict, out_dir: str, seed: int = 777) -> str:
    """Write flax's initial weights as OUT/epoch_0.pt with an epoch-0
    info; returns the .pt path."""
    state = flax_init(cfg, seed)[0]
    return ckpt_lib.save_checkpoint(out_dir, "epoch_0", state,
                                    {"epoch": 0, "step": 0})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("train_yaml")
    p.add_argument("out_dir")
    p.add_argument("--seed", type=int, default=777)
    args = p.parse_args(argv)
    path = write_epoch0(load_config(args.train_yaml), args.out_dir,
                        args.seed)
    state = torch.load(path, weights_only=True)
    digest = state_sha256(state)
    print(f"{path}: seed {args.seed}, {len(state)} tensors, "
          f"{sum(v.numel() for v in state.values())} parameters, "
          f"sha256 {digest}", flush=True)
    return digest


# ---------------------------------------------------------------- tests

SMALL_CONF = dict(
    d_model=32, attention_heads=4, linear_units=64, encoder_num_blocks=2,
    decoder_num_blocks=1, r_decoder_num_blocks=1, cnn_module_kernel=15,
    input_layer="conv2d", pos_enc_layer_type="rel_pos", macaron_style=True,
    use_cnn_module=True, reverse_weight=0.3, compute_dtype="float32")


def _small_cfg() -> dict:
    return {"model_conf": dict(SMALL_CONF), "input_size": 80,
            "vocab_size": 30, "use_global_cmvn": False}


def test_flax_init_fills_every_key_and_gives_jax_loss():
    """Every port parameter comes from flax's init, the same on a second
    draw, and the port model holding it gives JAX's loss on the same
    batch."""
    cfg = _small_cfg()
    state, tmodel, jmodel, params = flax_init(cfg, seed=777)
    assert set(state) == set(tmodel.state_dict())
    again = flax_init(cfg, seed=777)[0]
    assert all(torch.equal(state[k], again[k]) for k in state)
    tmodel.load_state_dict(state, strict=True)
    tmodel.eval()
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 50, 80)).astype(np.float32)
    flen = np.array([50, 37], np.int32)
    tgt = rng.integers(2, 29, (2, 6)).astype(np.int32)
    tlen = np.array([6, 4], np.int32)
    jout = jmodel.apply(params, jnp.asarray(feats), jnp.asarray(flen),
                        jnp.asarray(tgt), jnp.asarray(tlen),
                        deterministic=True)
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(feats), torch.from_numpy(flen),
                      torch.from_numpy(tgt).long(),
                      torch.from_numpy(tlen).long())
    np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]),
                               rtol=1e-4)


def test_train_resumes_from_flax_epoch0_at_step_zero(tmp_path):
    """bin.train --checkpoint epoch_0.pt (no optimizer.pt) starts at
    epoch 0 and step 0 from flax's weights, with the schedule's first
    lr, and writes epoch_1."""
    data = build_tiny(str(tmp_path / "data"), n_utts=8, seed=5,
                      max_dur=1.4)
    vocab = len(load_dict(data["dict"]))
    conf = {"model_conf": dict(SMALL_CONF),
            "dataset_conf": {"batch_type": "static", "batch_size": 4},
            "optim_conf": {"lr": 0.001}, "warmup_steps": 10,
            "log_interval": 1}
    cfg_path = tmp_path / "conf.json"
    cfg_path.write_text(json.dumps(conf))
    exp = tmp_path / "exp"
    write_epoch0(dict(conf, input_size=80, vocab_size=vocab,
                      use_global_cmvn=False), str(exp))
    init = torch.load(exp / "epoch_0.pt", weights_only=True)
    state = train.main(["--config", str(cfg_path), "--train_data",
                        data["manifest"], "--cv_data", data["manifest"],
                        "--exp_dir", str(exp), "--dict", data["dict"],
                        "--device", "cpu", "--num_workers", "1",
                        "--max_epoch", "1",
                        "--checkpoint", str(exp / "epoch_0.pt")])
    log = (exp / "train.log").read_text()
    assert f"initialized {len(init)} tensors" in log
    assert "restored optimizer state" not in log
    rows = [json.loads(x) for x in
            (exp / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in rows if r["kind"] == "train"]
    assert [r["step"] for r in steps] == [1, 2] == [1, state.step]
    # WarmupLR, linear over its first 10 steps
    np.testing.assert_allclose([r["lr"] for r in steps],
                               [0.001 / 10, 0.002 / 10], rtol=1e-6)
    info = json.loads((exp / "epoch_1.json").read_text())
    assert (info["epoch"], info["step"]) == (1, 2)
    trained = torch.load(exp / "epoch_1.pt", weights_only=True)
    assert any(not torch.equal(trained[k], init[k]) for k in init)


# openeat_torch.quality.init_draw's line: path, seed, counts, sha256
DRAW_LINE = re.compile(r"^(\S+): seed (\d+), (\d+) tensors, (\d+) "
                       r"parameters, sha256 ([0-9a-f]{64})$")


def test_writer_prints_the_init_draw_line(tmp_path, capsys):
    """main prints init_draw's line: a draw at --seed 778 holds other
    tensors than 777's, and the same seed gives the same sha256 twice."""
    conf = tmp_path / "train.json"
    conf.write_text(json.dumps(_small_cfg()))
    got = {}
    for tag, seed in (("a", 778), ("b", 778), ("c", 777)):
        digest = main([str(conf), str(tmp_path / tag), "--seed",
                       str(seed)])
        line = capsys.readouterr().out.strip()
        m = DRAW_LINE.match(line)
        assert m, line
        state = torch.load(m[1], weights_only=True)
        assert m[1] == str(tmp_path / tag / "epoch_0.pt")
        assert (int(m[2]), int(m[3]), int(m[4]), m[5]) == (
            seed, len(state), sum(v.numel() for v in state.values()),
            digest)
        assert digest == state_sha256(state)
        got[tag] = digest, state
    assert got["a"][0] == got["b"][0]
    assert got["a"][0] != got["c"][0]
    differ = [k for k, v in got["a"][1].items()
              if not torch.equal(v, got["c"][1][k])]
    assert "ctc.ctc_lo.weight" in differ


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
