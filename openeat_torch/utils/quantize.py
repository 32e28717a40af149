"""Weight-only int8 quantization for the inference path (PyTorch).

Port of openeat_tpu/utils/quantize.py. `quantize_model` turns the weight
of every Dense (modules/layers.py) with at least `min_size` elements
into an int8 `q` [out, in] and a float32 per-output-channel `scale`
[out]: scale_o = max_i |w[o, i]| / 127 (a zero scale becomes 1), q =
clip(round(w / scale_o), -127, 127), computed in numpy as the JAX
package's `_quantize_leaf` computes it, so the leaves are bit-equal to
its QTensor's (transposed). Those are exactly the JAX package's 2-D
`kernel` leaves: conv2d kernels, the depthwise taps, embeddings (and so
the tied output head), biases, LayerNorms and the rel-pos biases stay
in float32.

`Dense.forward` widens `q * scale` in float32 and casts it once to the
compute dtype, as `maybe_dequantize` does, so every path that runs the
model (encode, encode_chunk, the CTC head, the decoders, decoder_step,
the LM) takes a quantized model unchanged. Quantize on the host after
the weights are loaded and before `.to(device)`, so int8 is what
crosses to the card; nothing quantized is saved.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from openeat_torch.modules.layers import Dense


def _quantize_weight(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(q int8 [out, in], scale float32 [out]) of a weight [out, in]."""
    w = np.asarray(w, dtype=np.float32)
    scale = np.max(np.abs(w), axis=1) / 127.0
    scale = np.where(scale == 0.0, 1.0, scale).astype(np.float32)
    q = np.clip(np.round(w / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


@torch.no_grad()
def quantize_model(model: nn.Module, *, min_size: int = 4096) -> nn.Module:
    """Quantize, in place, every Dense weight of at least `min_size`
    elements; returns `model`."""
    for m in model.modules():
        if isinstance(m, Dense) and m.weight.numel() >= min_size:
            dev = m.weight.device
            q, scale = _quantize_weight(m.weight.cpu().numpy())
            m.weight = None
            m.q = torch.from_numpy(q).to(dev)
            m.scale = torch.from_numpy(scale).to(dev)
    return model


def quantized_bytes(model: nn.Module) -> tuple[int, int]:
    """(bytes now, bytes in float32) over the model's weights, counted
    as the JAX package counts its leaves: q and scale for a quantized
    Dense, every parameter at its own width."""
    now = fp32 = 0
    for m in model.modules():
        if isinstance(m, Dense) and m.q is not None:
            now += m.q.numel() + m.scale.numel() * 4
            fp32 += m.q.numel() * 4
    for p in model.parameters():
        now += p.numel() * p.element_size()
        fp32 += p.numel() * 4
    return now, fp32
