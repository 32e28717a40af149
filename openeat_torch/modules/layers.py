"""Basic layers with flax's dtype rule: parameters are stored in float32
and cast, together with the input, to the compute dtype at use.

These stand in for flax.linen's Dense, LayerNorm, Conv and Embed in the
ported modules. A cast goes through utils/weight_mirror.py:at_compute,
which inside a training step's forward hands out the weight mirror's
bfloat16 copy of the parameter instead of casting it. Weights are in
PyTorch's layout (Linear [out, in], Conv2d [out, in, kh, kw]);
openeat_torch/utils/param_bridge.py converts from flax's. A Dense or
Embed that openeat_torch/parallel/mesh.py shards over the mesh's model
group holds its shard and runs the sharded forward of
openeat_torch/parallel/tensor_parallel.py; unsharded, tp_mode is None.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from openeat_torch.parallel import tensor_parallel as tp
from openeat_torch.utils.weight_mirror import at_compute


class Dense(nn.Linear):
    """nn.Linear in the compute dtype. After utils/quantize.py's
    quantize_model, `weight` is None and the int8 `q` [out, in] with its
    float32 per-output `scale` [out] stand in for it: each forward widens
    them in float32 and casts once, as the JAX package's
    maybe_dequantize does."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        self.register_buffer("q", None)
        self.register_buffer("scale", None)
        self.tp_mode: str | None = None   # "column", "gather" or "row"
        self.tp_group = None

    def dense_weight(self) -> torch.Tensor:
        """The weight [out, in] in the compute dtype."""
        if self.q is None:
            return at_compute(self.weight, self.compute_dtype)
        return (self.q.float() * self.scale[:, None]).to(self.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_mode is not None:
            return tp.dense_forward(self, x)
        return self.local(x)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's product with no collective: the whole layer, a
        column shard with its bias, or a row shard's partial sum without
        the bias (which the caller adds once, after the sum)."""
        dt = self.compute_dtype
        bias = (None if self.bias is None or self.tp_mode == "row"
                else at_compute(self.bias, dt))
        return F.linear(x.to(dt), self.dense_weight(), bias)


class LayerNorm(nn.LayerNorm):
    """Statistics in float32, output in the compute dtype (flax's
    LayerNorm with dtype=compute_dtype)."""

    def __init__(self, dim: int, eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


class Conv2d(nn.Conv2d):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel, stride=stride)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), at_compute(self.weight, dt),
                        at_compute(self.bias, dt), self.stride)


class Embed(nn.Embedding):
    def __init__(self, num: int, dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num, dim)
        self.compute_dtype = dtype
        self.tp_group = None   # set when the table is vocab-sharded

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.tp_group is not None:
            return tp.embed_forward(self, ids)
        return F.embedding(ids, self.weight).to(self.compute_dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied output head: x @ embedding^T in the compute dtype."""
        if self.tp_group is not None:
            return tp.embed_attend(self, x)
        dt = self.compute_dtype
        return F.linear(x.to(dt), at_compute(self.weight, dt))
