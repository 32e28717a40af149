"""Operations and bytes, counted from shapes.

- `conformer_forward_flops`: the matrix products and convolutions of one
  utterance's forward through the hybrid CTC/attention Conformer (a
  multiply-add counts 2): the conv2d x4 subsampling, the encoder blocks
  (two FFNs, the projections, the rel-pos scores over 2 d_k and the
  context, the convolution module's pointwise and depthwise products),
  the CTC head and both decoders with their output layers. The rel-pos
  projection of the position rows runs once a batch, on the padded
  length, and is counted apart (`pos_flops`). A training step is 3x the
  forward (the backward twice the forward's products).
- `dwconv_bound_s`, `ctc_bound_s`: the least time of one launch of the
  depthwise-convolution kernel (forward, dgrad, wgrad) and of the CTC
  kernel: the larger of bytes over the HBM bandwidth and operations
  over the non-tensor float rate, each input byte read once and each
  output byte written once.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def peaks(device_name: str) -> dict | None:
    """The peak rates of a card by its name, or None for another card."""
    with open(PEAKS_FILE, encoding="utf-8") as f:
        return json.load(f).get(device_name)


def conv_out(n: int, k: int = 3, s: int = 2) -> int:
    return (n - k) // s + 1


def subsampled(frames: int) -> int:
    return conv_out(conv_out(frames))


def conformer_forward_flops(frames: int, tokens: int, m: dict,
                            vocab: int, mel: int = 80) -> int:
    """One utterance of `frames` fbank frames and `tokens` tokens."""
    d, ff = m["d_model"], m["linear_units"]
    k = m["cnn_module_kernel"]
    t1, f1 = conv_out(frames), conv_out(mel)
    t, f2 = conv_out(t1), conv_out(f1)
    sub = 2 * d * t1 * f1 * 9 + 2 * d * d * 9 * t * f2 + 2 * t * f2 * d * d
    block = (2 * 2 * 2 * t * d * ff        # two FFNs, two products each
             + 4 * 2 * t * d * d           # q, k, v, out
             + 2 * t * t * 2 * d           # (q+u)k + (q+v)p over 2 d_k
             + 2 * t * t * d               # context
             + 2 * t * d * 2 * d           # pointwise_conv1
             + 2 * t * d * k               # depthwise
             + 2 * t * d * d)              # pointwise_conv2
    enc = sub + m["encoder_num_blocks"] * block
    ctc = 2 * t * d * vocab
    lq = tokens + 1
    layer = (4 * 2 * lq * d * d + 2 * 2 * lq * lq * d       # self
             + 2 * 2 * lq * d * d + 2 * 2 * t * d * d       # src q, out; k, v
             + 2 * 2 * lq * t * d                           # src scores, ctx
             + 2 * 2 * lq * d * ff)                         # FFN
    n_dec = m["decoder_num_blocks"] + m.get("r_decoder_num_blocks", 0)
    n_heads = 1 + (m.get("r_decoder_num_blocks", 0) > 0)
    dec = n_dec * layer + n_heads * 2 * lq * d * vocab
    return enc + ctc + dec


def pos_flops(padded_frames: int, m: dict) -> int:
    """The rel-pos projection of a batch's position rows, every block."""
    t = subsampled(padded_frames)
    return m["encoder_num_blocks"] * 2 * t * m["d_model"] ** 2


def dwconv_bound_s(entry: str, b: int, t_in: int, c: int, k: int,
                   itemsize: int, pk: dict) -> float:
    """entry: "fwd", "dgrad" or "wgrad"; (b, t_in, c) the forward's input
    [B, T+K-1, C]."""
    t = t_in - k + 1
    flops = 2 * b * t * c * k
    if entry == "wgrad":        # x and dy in, dw out
        nbytes = itemsize * (b * t_in * c + b * t * c + k * c)
    else:                       # the input, the taps, the output
        nbytes = itemsize * (b * t_in * c + k * c + b * t * c)
    return max(nbytes / pk["hbm_bytes_per_s"], flops / pk["fp32_flops"])


def ctc_bound_s(b: int, t: int, s: int, pk: dict) -> float:
    """[B, T, S] float32 label log-probs in, gamma of the same shape out,
    about 10 operations a (t, s) cell for alpha and beta each."""
    nbytes = 4 * 2 * b * t * s
    flops = 2 * 10 * b * t * s
    return max(nbytes / pk["hbm_bytes_per_s"], flops / pk["fp32_flops"])
