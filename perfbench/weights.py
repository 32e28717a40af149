"""Seeded weights, drawn by the benchmark on the device in a few large
calls and handed to the program and to the reference alike.

By parameter kind, as the recipe's initializers give them: a matrix or
convolution weight a truncated normal (at two standard deviations,
variance 1 / fan-in, fan-in the product of the dimensions after the
first; a depthwise kernel [K, C] fan-in K), an embedding N(0, 1/d),
rel-pos biases [H, d_k] xavier uniform. Where the recipe starts a bias
or a LayerNorm shift at 0 and a LayerNorm scale at 1, these are drawn
about those values (N(0, 0.02^2) and 1 + N(0, 0.02^2)), as any trained
model has them: with every bias 0, a frame that SpecAugment zeroes
leaves the subsampling's output constant, the first LayerNorm (eps
1e-12) then multiplies its gradient by 1e6, and the first updates clip
to one leaf alone. One uniform draw serves all truncated normals (by
the inverse normal CDF), one normal draw the embeddings, one the biases
and scales, one uniform draw the rel-pos biases.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NEAR_STD = 0.02


def kind(name: str, shape: tuple) -> str:
    leaf = name.rsplit(".", 1)[-1]
    module = name.rsplit(".", 2)[-2] if name.count(".") >= 1 else ""
    if leaf.startswith("pos_bias_"):
        return "xavier"
    if leaf == "bias" or len(shape) == 1:
        return "near"         # a bias, a LayerNorm shift or scale
    if module == "embed":
        return "embed"
    return "trunc"


def fan_in(name: str, shape: tuple) -> int:
    if name.endswith("depthwise_conv.weight"):
        return int(shape[0])
    return int(np.prod(shape[1:]))


def draw(shapes: dict[str, tuple], seed: int,
         device: torch.device) -> dict[str, torch.Tensor]:
    """float32 weights by name for parameters of `shapes`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    kinds = {n: kind(n, s) for n, s in shapes.items()}

    def numel(k):
        return sum(int(np.prod(s)) for n, s in shapes.items()
                   if kinds[n] == k)

    out: dict[str, torch.Tensor] = {}
    # truncated normal at +-2 sigma by the inverse CDF
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    u = torch.empty(numel("trunc"), device=device).uniform_(
        2 * lo - 1, 1 - 2 * lo, generator=gen)
    z = torch.erfinv(u).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    e = torch.empty(numel("embed"), device=device).normal_(generator=gen)
    x = torch.empty(numel("xavier"), device=device).uniform_(
        -1.0, 1.0, generator=gen)
    near = torch.empty(numel("near"), device=device).normal_(
        0.0, NEAR_STD, generator=gen)
    taken = {"trunc": 0, "embed": 0, "xavier": 0, "near": 0}
    pools = {"trunc": z, "embed": e, "xavier": x, "near": near}
    for n, s in shapes.items():
        k = kinds[n]
        size = int(np.prod(s))
        part = pools[k][taken[k]:taken[k] + size].view(s)
        taken[k] += size
        if k == "near":
            is_scale = len(s) == 1 and not n.endswith(".bias")
            out[n] = part + 1.0 if is_scale else part.clone()
            continue
        if k == "trunc":
            # 0.8796: the std of a unit normal truncated at +-2
            scale = math.sqrt(1.0 / fan_in(n, s)) / 0.87962566103423978
        elif k == "embed":
            scale = s[1] ** -0.5
        else:
            scale = math.sqrt(6.0 / (s[0] + s[1]))
        out[n] = part * scale
    return out
