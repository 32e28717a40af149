"""openeat_torch's WeNet converter against the JAX package's, on the CPU.

- a synthetic WeNet state_dict, keyed and shaped as
  tests/test_wenet_convert.py builds one (global CMVN, conv2d x4 embed,
  Conformer blocks with the macaron FFN and the conv module, a 1+1
  bidirectional decoder), with adapters in every block, a
  concat_linear tensor and a positional-encoding buffer that no
  parameter takes: the port's convert_wenet_state_dict equals the JAX
  package's converter followed by the weight bridge, tensor for tensor,
  bit for bit, and fills the port's model strictly;
- convert_wenet_config gives the JAX package's dict for a Conformer /
  bitransformer release and a Transformer one;
- end to end: a WeNet-layout final.pt and train.yaml (tiny Conformer,
  d = 64, vocab from the dict) through each package's convert_wenet,
  then each package's recognize CLI (the port's with --device cpu) on
  the tiny corpus with the WeNet train.yaml as --config: the same
  hypotheses in ctc_greedy_search and attention_rescoring, both
  decoding raw fbank through the checkpoint's global CMVN. A WeNet
  config names no compute dtype and both packages default to
  bfloat16, so both CLIs' config conversion is wrapped to add
  compute_dtype float32: the numbers compared are float32 on both
  sides, as in tests/test_torch_recognize.py.
"""

import json

import numpy as np
import pytest
import torch
import yaml

from openeat_tpu.bin import convert_wenet as jax_convert_cli
from openeat_tpu.bin import recognize as jax_recognize
from openeat_tpu.utils import wenet_convert as jax_wenet_convert
from openeat_tpu.utils.checkpoint import _flatten
from openeat_tpu.utils.wenet_convert import \
    convert_wenet_config as jax_convert_config
from openeat_tpu.utils.wenet_convert import \
    convert_wenet_state_dict as jax_convert
from openeat_torch.bin import convert_wenet, recognize
from openeat_torch.dataset.text import load_dict
from openeat_torch.models.asr_model import build_asr_model
from openeat_torch.utils.param_bridge import flax_to_state_dict
from openeat_torch.utils.wenet_convert import (convert_wenet_config,
                                               convert_wenet_state_dict,
                                               is_wenet_config)
from tests.make_tiny_data import build as build_tiny

torch.set_num_threads(1)
F = 80


def wenet_state(rng, d, heads, ff, k, vocab, n_enc, n_dec,
                adapter_size=0):
    """A WeNet-named state_dict with reference shapes: matrices scaled by
    1/sqrt(fan_in), LayerNorm gains near 1, small biases, CMVN
    statistics in the range of log-mel features."""
    s = {}

    def mat(*shape):
        return (rng.standard_normal(shape)
                / np.sqrt(np.prod(shape[1:]))).astype(np.float32)

    def vec(n, around=0.0):
        return (around + 0.1 * rng.standard_normal(n)).astype(np.float32)

    def norm(p):
        s[p + ".weight"], s[p + ".bias"] = vec(d, 1.0), vec(d)

    def linear(p, n_out, n_in):
        s[p + ".weight"], s[p + ".bias"] = mat(n_out, n_in), vec(n_out)

    def attention(p):
        for a in ("linear_q", "linear_k", "linear_v", "linear_out"):
            linear(f"{p}.{a}", d, d)

    def adapter(p):
        if adapter_size:
            norm(p + ".adapter.norm")
            linear(p + ".adapter.down_proj", adapter_size, d)
            linear(p + ".adapter.up_proj", d, adapter_size)

    s["encoder.global_cmvn.mean"] = vec(F, 8.0)
    s["encoder.global_cmvn.istd"] = (1.0 / rng.uniform(2.0, 4.0, F)).astype(
        np.float32)
    s["encoder.embed.conv.0.weight"] = mat(d, 1, 3, 3)
    s["encoder.embed.conv.0.bias"] = vec(d)
    s["encoder.embed.conv.2.weight"] = mat(d, d, 3, 3)
    s["encoder.embed.conv.2.bias"] = vec(d)
    linear("encoder.embed.out.0", d, d * (((F - 1) // 2 - 1) // 2))
    s["encoder.embed.pos_enc.pe"] = mat(1, 500, d)   # a buffer: dropped
    for i in range(n_enc):
        p = f"encoder.encoders.{i}"
        attention(p + ".self_attn")
        s[p + ".self_attn.linear_pos.weight"] = mat(d, d)
        s[p + ".self_attn.pos_bias_u"] = mat(heads, d // heads)
        s[p + ".self_attn.pos_bias_v"] = mat(heads, d // heads)
        for f in ("feed_forward", "feed_forward_macaron"):
            linear(f"{p}.{f}.w_1", ff, d)
            linear(f"{p}.{f}.w_2", d, ff)
        s[p + ".conv_module.pointwise_conv1.weight"] = mat(2 * d, d, 1)
        s[p + ".conv_module.pointwise_conv1.bias"] = vec(2 * d)
        s[p + ".conv_module.depthwise_conv.weight"] = mat(d, 1, k)
        s[p + ".conv_module.depthwise_conv.bias"] = vec(d)
        s[p + ".conv_module.pointwise_conv2.weight"] = mat(d, d, 1)
        s[p + ".conv_module.pointwise_conv2.bias"] = vec(d)
        norm(p + ".conv_module.norm")
        for n in ("norm_ff", "norm_mha", "norm_conv", "norm_ff_macaron",
                  "norm_final"):
            norm(f"{p}.{n}")
        adapter(p)
        s[p + ".concat_linear.weight"] = mat(d, 2 * d)   # skipped
    norm("encoder.after_norm")
    linear("ctc.ctc_lo", vocab, d)
    for side in ("left_decoder", "right_decoder"):
        p = f"decoder.{side}"
        s[p + ".embed.0.weight"] = rng.standard_normal(
            (vocab, d)).astype(np.float32)
        for i in range(n_dec):
            q = f"{p}.decoders.{i}"
            attention(q + ".self_attn")
            attention(q + ".src_attn")
            linear(q + ".feed_forward.w_1", ff, d)
            linear(q + ".feed_forward.w_2", d, ff)
            for n in ("norm1", "norm2", "norm3"):
                norm(f"{q}.{n}")
            adapter(q)
        norm(p + ".after_norm")
        linear(p + ".output_layer", vocab, d)
    return s


def wenet_yaml(d, heads, ff, k, n_enc, n_dec, output_dim=None) -> dict:
    cfg = {"encoder": "conformer",
           "encoder_conf": {"output_size": d, "attention_heads": heads,
                            "linear_units": ff, "num_blocks": n_enc,
                            "cnn_module_kernel": k, "dropout_rate": 0.1},
           "decoder": "bitransformer",
           "decoder_conf": {"attention_heads": heads, "linear_units": ff,
                            "num_blocks": n_dec, "r_num_blocks": n_dec},
           "model_conf": {"ctc_weight": 0.3, "lsm_weight": 0.1,
                          "reverse_weight": 0.3},
           "dataset_conf": {"fbank_conf": {"num_mel_bins": F}}}
    if output_dim is not None:
        cfg["output_dim"] = output_dim
    return cfg


def test_state_dict_equals_jax_and_the_bridge():
    d, heads, ff, k, vocab = 16, 2, 32, 7, 30
    state = wenet_state(np.random.default_rng(0), d, heads, ff, k, vocab,
                        2, 1, adapter_size=8)
    got = convert_wenet_state_dict(
        {key: torch.from_numpy(v) for key, v in state.items()}, d)
    conf = dict(convert_wenet_config(wenet_yaml(d, heads, ff, k, 2, 1))[
        "model_conf"], encoder_use_adapter=True, decoder_use_adapter=True,
        down_size=8, compute_dtype="float32")
    model = build_asr_model(conf, F, vocab, use_global_cmvn=True)
    want = flax_to_state_dict(_flatten(jax_convert(state, d)), model)
    assert set(got) == set(want) == set(model.state_dict())
    for key, w in want.items():
        assert got[key].dtype == torch.float32
        assert torch.equal(got[key], w), key
    model.load_state_dict(got, strict=True)
    assert not any("concat_linear" in key or "pos_enc" in key
                   for key in got)


@pytest.mark.parametrize("cfg", [
    wenet_yaml(256, 4, 2048, 15, 12, 3, output_dim=4233),
    {"encoder": "transformer", "decoder": "transformer",
     "encoder_conf": {"output_size": 256, "num_blocks": 6},
     "decoder_conf": {"num_blocks": 6}, "input_dim": 40,
     "model_conf": {"ctc_weight": 0.5, "length_normalized_loss": True},
     "dataset_conf": {"max_length": 3000}},
], ids=["conformer", "transformer"])
def test_config_equals_jax(cfg):
    assert is_wenet_config(cfg)
    got = convert_wenet_config(cfg)
    assert got == jax_convert_config(cfg)
    assert got["collate_conf"]["normalization"] is False


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_wenet")
    data = build_tiny(str(root), n_utts=6, seed=2, max_dur=1.5)
    vocab = len(load_dict(data["dict"]))
    state = wenet_state(np.random.default_rng(1), 64, 4, 128, 15, vocab, 2,
                        1)
    pt = str(root / "final.pt")
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, pt)
    cfg_path = str(root / "train.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(wenet_yaml(64, 4, 128, 15, 2, 1), f)
    ported = convert_wenet.main(["--pt", pt, "--d_model", "64", "--out",
                                 str(root / "port" / "converted"),
                                 "--wenet_config", cfg_path])
    jax_convert_cli.main(["--pt", pt, "--d_model", "64", "--out",
                          str(root / "jax" / "converted")])
    return dict(root=root, data=data, pt=ported, cfg=cfg_path,
                jax_ckpt=str(root / "jax" / "converted"))


def test_convert_cli_writes_the_checkpoint_and_config(release):
    adapted = json.loads((release["root"] / "port" / "train.json")
                         .read_text())
    assert adapted["model_conf"]["d_model"] == 64
    assert adapted["collate_conf"]["normalization"] is False
    info = json.loads((release["root"] / "port" / "converted.json")
                      .read_text())
    state = torch.load(release["pt"], weights_only=True)
    assert info["tensors"] == len(state)
    assert "encoder.global_cmvn.mean" in state


@pytest.mark.parametrize("mode", ["ctc_greedy_search",
                                  "attention_rescoring"])
def test_recognize_on_a_wenet_config_writes_the_jax_text(release, mode,
                                                         monkeypatch):
    def float32(convert):
        def run(cfg):
            out = convert(cfg)
            out["model_conf"]["compute_dtype"] = "float32"
            return out
        return run

    monkeypatch.setattr(recognize, "convert_wenet_config",
                        float32(convert_wenet_config))
    monkeypatch.setattr(jax_wenet_convert, "convert_wenet_config",
                        float32(jax_convert_config))
    d = release["data"]
    outs = []
    for name, main, ckpt, device in (
            ("port", recognize.main, release["pt"], ["--device", "cpu"]),
            ("jax", jax_recognize.main, release["jax_ckpt"], [])):
        out = str(release["root"] / f"{name}_{mode}.txt")
        main(["--config", release["cfg"], "--checkpoint", ckpt,
              "--test_data", d["manifest"], "--dict", d["dict"],
              "--result_file", out, "--mode", mode, "--batch_size", "4",
              "--beam_size", "4", "--reverse_weight", "0.3", *device])
        with open(out, encoding="utf-8") as f:
            outs.append(dict(line.rstrip("\n").split(" ", 1)
                             for line in f))
    assert outs[0] == outs[1]
    assert set(outs[0]) == set(d["texts"])
    assert any(outs[0].values())
