"""Weight bridge: flax parameter leaves -> the port's state_dict.

Input is a flat dict of numpy arrays keyed as the JAX package's
utils/checkpoint.py:_flatten keys them, e.g.
``params/encoder/encoders/layer_0/conv_module/depthwise_conv/kernel``.
The port names its modules after the flax tree, so a key's module path
is the torch module path; this file owns every layout change:

- Dense kernel [in, out] -> Linear weight [out, in];
- Conv kernel [kh, kw, in, out] -> Conv2d weight [out, in, kh, kw];
- depthwise Conv kernel [K, 1, C] -> K3 taps [K, C];
- LayerNorm scale -> weight; Embed embedding -> weight.

A leaf that maps to no parameter of the model, and a parameter that no
leaf fills, both raise.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from openeat_torch.modules.attention import RelPositionMultiHeadedAttention
from openeat_torch.modules.cmvn import GlobalCMVN
from openeat_torch.modules.convolution import DepthwiseConv1d
from openeat_torch.modules.layers import Conv2d, Dense, Embed, LayerNorm

# (module class, flax leaf) -> (torch parameter, layout change)
_RULES = {
    (Dense, "kernel"): ("weight", lambda a: a.T),
    (Dense, "bias"): ("bias", None),
    (LayerNorm, "scale"): ("weight", None),
    (LayerNorm, "bias"): ("bias", None),
    (Conv2d, "kernel"): ("weight", lambda a: a.transpose(3, 2, 0, 1)),
    (Conv2d, "bias"): ("bias", None),
    (DepthwiseConv1d, "kernel"): ("weight",
                                  lambda a: a.reshape(a.shape[0], -1)),
    (DepthwiseConv1d, "bias"): ("bias", None),
    (Embed, "embedding"): ("weight", None),
    (RelPositionMultiHeadedAttention, "pos_bias_u"): ("pos_bias_u", None),
    (RelPositionMultiHeadedAttention, "pos_bias_v"): ("pos_bias_v", None),
    (GlobalCMVN, "mean"): ("mean", None),
    (GlobalCMVN, "istd"): ("istd", None),
}


def flax_to_state_dict(flat: dict[str, np.ndarray],
                       model: nn.Module) -> dict[str, torch.Tensor]:
    """Convert `_flatten`-keyed flax leaves into `model`'s state_dict."""
    target = model.state_dict()
    state: dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        mod_path, leaf = ".".join(parts[:-1]), parts[-1]
        try:
            module = model.get_submodule(mod_path)
        except AttributeError:
            raise KeyError(f"flax leaf {key!r}: the port has no module "
                           f"{mod_path!r}") from None
        rule = _RULES.get((type(module), leaf))
        if rule is None:
            raise KeyError(f"flax leaf {key!r}: no rule for leaf {leaf!r} "
                           f"of {type(module).__name__}")
        name, change = rule
        tname = f"{mod_path}.{name}"
        arr = np.asarray(value)
        if change is not None:
            arr = change(arr)
        if tname not in target:
            raise KeyError(f"flax leaf {key!r} -> {tname!r}, which the "
                           "model does not have")
        if tuple(arr.shape) != tuple(target[tname].shape):
            raise ValueError(f"flax leaf {key!r}: shape {arr.shape} after "
                             f"conversion, {tuple(target[tname].shape)} "
                             f"expected for {tname!r}")
        state[tname] = torch.tensor(arr, dtype=torch.float32)
    unfilled = sorted(set(target) - set(state))
    if unfilled:
        raise KeyError(f"no flax leaf fills {len(unfilled)} port "
                       f"parameter(s): {unfilled[:8]}")
    return state

