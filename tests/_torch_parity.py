"""Shared setup for the openeat_torch parity tests: one tiny Conformer
built in both packages with the same weights.

The flax parameter tree comes from `init` (traced only, for its shapes)
and its values are drawn with numpy from a seed, so that no bias is
zero and no LayerNorm is the identity: a wrong layout in the bridge
cannot hide behind an init constant. The port's model is filled through the weight bridge from the
flax leaves as openeat_tpu/utils/checkpoint.py:_flatten keys them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from openeat_tpu.models.asr_model import build_asr_model as build_jax_model
from openeat_tpu.utils.checkpoint import _flatten
from openeat_torch.models.asr_model import \
    build_asr_model as build_torch_model
from openeat_torch.utils.param_bridge import flax_to_state_dict

VOCAB = 40
FEAT_DIM = 80
TINY_CONF = dict(
    d_model=64, attention_heads=4, linear_units=128, encoder_num_blocks=2,
    decoder_num_blocks=1, r_decoder_num_blocks=1, cnn_module_kernel=15,
    input_layer="conv2d", pos_enc_layer_type="rel_pos", macaron_style=True,
    use_cnn_module=True, reverse_weight=0.3, compute_dtype="float32")


def _draw(rng: np.random.Generator, leaf: str, shape) -> np.ndarray:
    """Random value for one flax leaf: kernels scaled by 1/sqrt(fan_in),
    LayerNorm scales near 1, biases and the rest small."""
    x = rng.standard_normal(shape).astype(np.float32)
    if leaf == "kernel":
        return x / np.sqrt(np.prod(shape[:-1]))
    if leaf == "scale":
        return 1.0 + 0.1 * x
    if leaf == "embedding":
        return x
    return 0.1 * x


def tiny_models(seed: int = 0, **overrides):
    """(jax_model, flax variables, flat leaves, torch_model) for the tiny
    Conformer with `overrides` applied to its model_conf."""
    conf = dict(TINY_CONF, **overrides)
    jmodel = build_jax_model(conf, FEAT_DIM, VOCAB)
    rng = np.random.default_rng(seed)
    feats = jnp.zeros((1, 40, FEAT_DIM), jnp.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), feats,
                            jnp.array([40]), jnp.ones((1, 4), jnp.int32),
                            jnp.array([4]))
    variables = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(_draw(rng, path[-1].key, leaf.shape)),
        shapes)
    flat = _flatten(variables)
    tmodel = build_torch_model(conf, FEAT_DIM, VOCAB)
    tmodel.load_state_dict(flax_to_state_dict(flat, tmodel), strict=True)
    return jmodel, variables, flat, tmodel.eval()


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
