"""The port's input layers and the no-position encoding against JAX.

The tiny Conformer of tests/_torch_parity.py (2 blocks, d=64) with
input_layer linear, conv2d6 or conv2d8 and with pos_enc_layer_type
no_pos, its weights drawn with numpy and carried over by the weight
bridge, float32, dropout 0. On a seeded batch: the encoder output
within 1e-4 relative (atol 1e-5) and its lengths equal; the joint loss,
loss_ctc and loss_att within 1e-5 relative. For the linear layer (the
one with a new dropout site and LayerNorm) every gradient within 2e-4
of its tensor's max |grad| plus 1e-7 of the model's largest (twice the
bound of tests/test_torch_train_step.py: at rate 1 each sum runs over
4x the frames). Each layer's subsampling rate and right context equal
JAX's, and recognize's timestamps count the rate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openeat_tpu.modules import subsampling as jax_sub
from openeat_tpu.utils.checkpoint import _flatten
from openeat_torch.bin.recognize import position_ms
from openeat_torch.modules import subsampling
from openeat_torch.modules.dropout import Dropout, set_generator
from openeat_torch.models.asr_model import build_asr_model
from openeat_torch.modules.embedding import NoPositionalEncoding
from openeat_torch.utils.param_bridge import flax_to_state_dict
from tests._torch_parity import (FEAT_DIM, TINY_CONF, VOCAB, tiny_models,
                                 to_np)

torch.set_num_threads(1)
CASES = [("linear", "rel_pos"), ("conv2d6", "rel_pos"),
         ("conv2d8", "abs_pos"), ("conv2d", "no_pos")]


def _batch(t=91):
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((3, t, FEAT_DIM)).astype(np.float32)
    lens = np.array([t, t - 20, 47], np.int32)
    ys = rng.integers(1, VOCAB - 1, (3, 6)).astype(np.int32)
    ys_lens = np.array([6, 4, 2], np.int32)
    for i, n in enumerate(ys_lens):
        ys[i, n:] = -1
    return feats, lens, ys, ys_lens


def _port_metrics(tm, feats, lens, ys, ys_lens) -> dict:
    tm.train()
    return tm(torch.from_numpy(feats), torch.from_numpy(lens).long(),
              torch.from_numpy(ys).long(), torch.from_numpy(ys_lens).long())


@pytest.mark.parametrize("input_layer,pos_enc", CASES)
def test_encoder_and_loss_equal_jax(input_layer, pos_enc):
    jm, variables, _, tm = tiny_models(
        3, input_layer=input_layer, pos_enc_layer_type=pos_enc,
        dropout_rate=0.0)
    feats, lens, ys, ys_lens = _batch()
    j_out, j_lens = jm.apply(variables, jnp.asarray(feats),
                             jnp.asarray(lens), method=jm.encode)
    out, out_lens = tm.encode(torch.from_numpy(feats),
                              torch.from_numpy(lens).long())
    np.testing.assert_array_equal(to_np(out_lens), np.asarray(j_lens))
    np.testing.assert_allclose(to_np(out), np.asarray(j_out), rtol=1e-4,
                               atol=1e-5)
    j_metrics = jm.apply(variables, jnp.asarray(feats), jnp.asarray(lens),
                         jnp.asarray(ys), jnp.asarray(ys_lens))
    with torch.no_grad():
        metrics = _port_metrics(tm, feats, lens, ys, ys_lens)
    for key in ("loss", "loss_ctc", "loss_att"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(j_metrics[key]), rtol=1e-5,
                                   err_msg=key)


def test_linear_layer_gradients_equal_jax():
    """The rate-1 layer feeds 4x the frames of conv2d x4 into every
    gradient sum, so its bound is 2e-4 of each tensor's max |grad|."""
    jm, variables, _, tm = tiny_models(3, input_layer="linear",
                                       dropout_rate=0.0)
    feats, lens, ys, ys_lens = _batch()

    def loss_fn(v):
        return jm.apply(v, jnp.asarray(feats), jnp.asarray(lens),
                        jnp.asarray(ys), jnp.asarray(ys_lens))["loss"]

    j_grads = jax.grad(loss_fn)(variables)
    _port_metrics(tm, feats, lens, ys, ys_lens)["loss"].backward()
    want = flax_to_state_dict(_flatten(j_grads), tm)
    g_max = max(float(g.abs().max()) for g in want.values())
    for name, p in tm.named_parameters():
        ref = want[name].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 2e-4 * np.abs(ref).max() + 1e-7 * g_max, (name, err)


@pytest.mark.parametrize("name", ["linear", "conv2d", "conv2d6", "conv2d8"])
def test_rates_and_right_context_equal_jax(name):
    port, ref = subsampling.SUBSAMPLE_CLASSES[name], \
        jax_sub.SUBSAMPLE_CLASSES[name]
    fields = ref.__dataclass_fields__
    assert port.subsampling_rate == fields["subsampling_rate"].default
    assert port.right_context == fields["right_context"].default
    model = build_asr_model(dict(TINY_CONF, input_layer=name), FEAT_DIM,
                            VOCAB)
    assert position_ms(model) == 10.0 * fields["subsampling_rate"].default


def test_linear_layer_drops_out_and_no_pos_is_zero():
    _, _, _, tm = tiny_models(0, input_layer="linear",
                              pos_enc_layer_type="no_pos", dropout_rate=0.5)
    embed = tm.encoder.embed
    assert isinstance(embed.dropout, Dropout) and embed.dropout.rate == 0.5
    assert isinstance(embed.pos_enc, NoPositionalEncoding)
    x = torch.randn(2, 30, FEAT_DIM,
                    generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([30, 20])
    eval_out, pos, _ = embed.eval()(x, lens)
    assert torch.count_nonzero(pos) == 0 and pos.shape == (1, 30, 64)
    embed.train()
    set_generator(embed, torch.Generator().manual_seed(0))
    a, _, _ = embed(x, lens)
    set_generator(embed, torch.Generator().manual_seed(0))
    b, _, _ = embed(x, lens)
    assert torch.equal(a, b)
    dropped = (a == 0) & (eval_out != 0)
    assert 0.4 < dropped.float().mean() < 0.6
    torch.testing.assert_close(a[~dropped], 2.0 * eval_out[~dropped])
