"""WeNet / reference PyTorch checkpoint -> the port's state_dict.

Port of openeat_tpu/utils/wenet_convert.py (numpy only; the port keeps
its own copy of the config rules). The port names its modules after the
JAX package's flax tree and keeps PyTorch's weight layouts, so most
WeNet tensors are renamed as they are:

- encoder.encoders.{i}.* -> encoder.encoders.layer_{i}.*, the decoders'
  decoders.{i}.* -> decoders.layer_{i}.*, encoder.after_norm ->
  encoder.encoders.after_norm, decoder.{left,right}_decoder.embed.0 ->
  .embed, a plain decoder.* -> decoder.left_decoder.*;
- encoder.embed.conv.{0,2} -> encoder.embed.Conv_{0,1} (Conv2d
  [out, in, kh, kw] in both);
- the conv module's pointwise Conv1d [out, in, 1] -> Dense [out, in];
  its depthwise Conv1d [C, 1, K] -> K3's taps [K, C].

Where the layouts differ, JAX's rules hold: the post-subsampling
projection encoder.embed.out.0 [d, C*F] flattens its input in torch's
(C, F) order and the port's Dense_0 in (F, C) order (modules/
subsampling.py), so its columns are re-permuted; `concat_linear`
tensors are skipped, as the reference skips them; a name that maps to
nothing (e.g. a positional-encoding buffer) is dropped.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _block_key(rest: str, w: np.ndarray):
    """(port name inside an encoder or decoder block, tensor) or None."""
    if re.fullmatch(r"(self_attn|src_attn)\.(linear_(q|k|v|out|pos)\.(weight"
                    r"|bias)|pos_bias_u|pos_bias_v)", rest):
        return rest, w
    if re.fullmatch(r"(feed_forward|feed_forward_macaron)\.w_[12]\."
                    r"(weight|bias)", rest):
        return rest, w
    m = re.fullmatch(r"conv_module\.(pointwise_conv[12])\.(weight|bias)",
                     rest)
    if m:
        return rest, (w[..., 0] if m.group(2) == "weight" else w)
    m = re.fullmatch(r"conv_module\.depthwise_conv\.(weight|bias)", rest)
    if m:
        return rest, (w[:, 0, :].T if m.group(1) == "weight" else w)
    if re.fullmatch(r"(conv_module\.norm|norm_ff|norm_mha|norm_conv"
                    r"|norm_ff_macaron|norm_final|norm1|norm2|norm3)\."
                    r"(weight|bias)", rest):
        return rest, w
    if re.fullmatch(r"adapter\.((down_proj|up_proj|norm)\.(weight|bias)"
                    r"|scale)", rest):
        return rest, w
    return None


def _convert_key(key: str, w: np.ndarray, d_model: int):
    """(port state_dict name, tensor) for one WeNet entry, or None."""
    if key in ("encoder.global_cmvn.mean", "encoder.global_cmvn.istd"):
        return key, w
    m = re.fullmatch(r"encoder\.embed\.conv\.(\d+)\.(weight|bias)", key)
    if m:   # torch Sequential conv, relu, conv, relu
        return f"encoder.embed.Conv_{int(m.group(1)) // 2}.{m.group(2)}", w
    m = re.fullmatch(r"encoder\.embed\.out\.0\.(weight|bias)", key)
    if m:
        if m.group(1) == "weight":
            # the input's torch flatten order (C, F) -> the port's (F, C)
            out_dim, in_dim = w.shape
            w = w.reshape(out_dim, d_model, in_dim // d_model).transpose(
                0, 2, 1).reshape(out_dim, in_dim)
        return f"encoder.embed.Dense_0.{m.group(1)}", w
    m = re.fullmatch(r"encoder\.embed\.(out|linear)\.(weight|bias)", key)
    if m:   # the linear-input variant
        return f"encoder.embed.Dense_0.{m.group(2)}", w
    m = re.fullmatch(r"encoder\.encoders\.(\d+)\.(.+)", key)
    if m:
        r = _block_key(m.group(2), w)
        return (f"encoder.encoders.layer_{m.group(1)}.{r[0]}", r[1]) \
            if r else None
    m = re.fullmatch(r"encoder\.after_norm\.(weight|bias)", key)
    if m:
        return f"encoder.encoders.after_norm.{m.group(1)}", w
    if re.fullmatch(r"ctc\.ctc_lo\.(weight|bias)", key):
        return key, w
    m = re.fullmatch(r"decoder\.(left_decoder|right_decoder)\.(.+)", key)
    if m:
        side, rest = m.groups()
    elif key.startswith("decoder."):
        side, rest = "left_decoder", key[len("decoder."):]
    else:
        return None
    base = f"decoder.{side}"
    if rest == "embed.0.weight":
        return f"{base}.embed.weight", w
    m = re.fullmatch(r"decoders\.(\d+)\.(.+)", rest)
    if m:
        r = _block_key(m.group(2), w)
        return (f"{base}.decoders.layer_{m.group(1)}.{r[0]}", r[1]) \
            if r else None
    if re.fullmatch(r"(after_norm|output_layer)\.(weight|bias)", rest):
        return f"{base}.{rest}", w
    return None


def convert_wenet_state_dict(state: dict[str, torch.Tensor], d_model: int
                             ) -> dict[str, torch.Tensor]:
    """WeNet state_dict -> the port's state_dict entries, float32 on the
    CPU."""
    out: dict[str, torch.Tensor] = {}
    for key, val in state.items():
        if "concat_linear" in key:
            continue
        w = val.detach().cpu().float().numpy()
        r = _convert_key(key, w, d_model)
        if r is not None:
            out[r[0]] = torch.from_numpy(np.ascontiguousarray(r[1]))
    return out


def is_wenet_config(cfg: dict) -> bool:
    """WeNet train.yaml layout: the architecture split over
    `encoder_conf` / `decoder_conf`, `model_conf` holding only the loss
    weights."""
    return "encoder_conf" in cfg or "decoder_conf" in cfg


def convert_wenet_config(cfg: dict) -> dict:
    """WeNet release train.yaml -> the framework config dict (the JAX
    package's rules): the flattened model_conf with WeNet's per-encoder
    positional-encoding default (Conformer rel_pos, Transformer
    abs_pos), input_size and vocab_size from input_dim / output_dim,
    and a collate_conf that feeds raw fbank (normalization false: the
    checkpoint's global CMVN normalizes inside the encoder)."""
    enc = dict(cfg.get("encoder_conf", {}) or {})
    dec = dict(cfg.get("decoder_conf", {}) or {})
    loss = dict(cfg.get("model_conf", {}) or {})
    is_conformer = cfg.get("encoder", "conformer") == "conformer"
    mc: dict = {
        "d_model": enc.get("output_size", 256),
        "attention_heads": enc.get("attention_heads", 4),
        "linear_units": enc.get("linear_units", 2048),
        "encoder_num_blocks": enc.get("num_blocks", 12),
        "dropout_rate": enc.get("dropout_rate", 0.1),
        "positional_dropout_rate": enc.get("positional_dropout_rate", 0.1),
        "input_layer": enc.get("input_layer", "conv2d"),
        "pos_enc_layer_type": enc.get(
            "pos_enc_layer_type", "rel_pos" if is_conformer else "abs_pos"),
        "activation": enc.get("activation_type", "swish"),
        "causal": bool(enc.get("causal", False)),
        "static_chunk_size": enc.get("static_chunk_size", 0),
        "use_dynamic_chunk": bool(enc.get("use_dynamic_chunk", False)),
        "decoder_num_blocks": dec.get("num_blocks", 3),
        "r_decoder_num_blocks": (dec.get("r_num_blocks", 3)
                                 if cfg.get("decoder") == "bitransformer"
                                 else dec.get("r_num_blocks", 0)),
        "ctc_weight": loss.get("ctc_weight", 0.3),
        "lsm_weight": loss.get("lsm_weight", 0.1),
        "reverse_weight": loss.get("reverse_weight", 0.0),
        "length_normalized_loss": bool(loss.get("length_normalized_loss",
                                                False)),
    }
    if is_conformer:
        mc["use_cnn_module"] = bool(enc.get("use_cnn_module", True))
        mc["cnn_module_kernel"] = enc.get("cnn_module_kernel", 15)
        mc["macaron_style"] = bool(enc.get("macaron_style", True))
    else:
        mc["use_cnn_module"] = False
        mc["macaron_style"] = False
    out: dict = {"model_conf": mc}
    ds = dict(cfg.get("dataset_conf", {}) or {})
    fbank = dict(ds.get("fbank_conf", {}) or {})
    mel = fbank.get("num_mel_bins", 80)
    out["input_size"] = cfg.get("input_dim", mel)
    if "output_dim" in cfg:
        out["vocab_size"] = cfg["output_dim"]
    out["collate_conf"] = {
        "feature_extraction_conf": {"mel_bins": mel,
                                    "resample_rate": 16000,
                                    "wav_dither": 0.0},
        "spec_aug": False,
        "normalization": False,
    }
    out["dataset_conf"] = {"max_length": ds.get("max_length", 10240),
                           "min_length": ds.get("min_length", 0)}
    return out


def load_wenet_checkpoint(path: str, d_model: int
                          ) -> dict[str, torch.Tensor]:
    """Load a WeNet .pt state_dict (or a dict holding one under
    "state_dict") with weights_only=True and convert it."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return convert_wenet_state_dict(
        {k: v for k, v in state.items() if isinstance(v, torch.Tensor)},
        d_model)
