"""openeat_torch model parity: the tiny Conformer (2 blocks, d=64, 4
heads, FFN 128, vocab 40, 1+1 decoders, kernel 15, rel_pos, conv2d) with
the same weights through the bridge gives the JAX model's encode,
ctc_log_probs and decoder_logits within atol 1e-4 / rtol 1e-4 (float32
on both sides; the gap is summation order)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openeat_tpu.models.asr_model import ASRModel
from openeat_tpu.utils.common import add_sos_eos as jax_add_sos_eos
from openeat_torch.models.asr_model import build_asr_model
from openeat_torch.utils.common import add_sos_eos, reverse_pad_list
from openeat_torch.utils.param_bridge import flax_to_state_dict
from tests._torch_parity import FEAT_DIM, TINY_CONF, VOCAB, tiny_models, \
    to_np

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((3, 57, FEAT_DIM)).astype(np.float32)
    lens = np.array([57, 41, 23], np.int32)
    return feats, lens


@pytest.mark.parametrize("overrides", [
    {},
    {"tie_word_embedding": True, "encoder_num_blocks": 4,
     "encoder_num_blocks_share": 2, "causal": True},
], ids=["flagship_shape", "tied_shared_causal"])
def test_encode_ctc_decoder_match_jax(overrides):
    jm, variables, _, tm = tiny_models(0, **overrides)
    feats, lens = _inputs()
    j_enc, j_lens = jax.jit(partial(jm.apply, method=ASRModel.encode))(
        variables, jnp.asarray(feats), jnp.asarray(lens))
    with torch.no_grad():
        t_enc, t_lens = tm.encode(torch.from_numpy(feats),
                                  torch.from_numpy(lens).long())
        t_lp = tm.ctc_log_probs(t_enc)
    np.testing.assert_array_equal(to_np(t_lens), to_np(j_lens))
    np.testing.assert_allclose(to_np(t_enc), to_np(j_enc), **TOL)
    j_lp = jax.jit(partial(jm.apply, method=ASRModel.ctc_log_probs))(
        variables, j_enc)
    np.testing.assert_allclose(to_np(t_lp), to_np(j_lp), **TOL)

    rng = np.random.default_rng(2)
    ys = rng.integers(1, VOCAB - 1, (3, 6)).astype(np.int32)
    ys_lens = np.array([6, 3, 1], np.int32)
    ys[1, 3:] = -1
    ys[2, 1:] = -1
    j_in, _ = jax_add_sos_eos(jnp.asarray(ys), jnp.asarray(ys_lens),
                              VOCAB - 1, VOCAB - 1)
    t_ys = torch.from_numpy(ys).long()
    t_ys_lens = torch.from_numpy(ys_lens).long()
    t_in, _ = add_sos_eos(t_ys, t_ys_lens, VOCAB - 1, VOCAB - 1)
    np.testing.assert_array_equal(to_np(t_in), to_np(j_in))
    r_in, _ = add_sos_eos(reverse_pad_list(t_ys, t_ys_lens), t_ys_lens,
                          VOCAB - 1, VOCAB - 1)
    for reverse, ys_in in ((False, t_in), (True, r_in)):
        j_logp = jax.jit(partial(jm.apply, method=ASRModel.decoder_logits),
                         static_argnums=5)(
            variables, j_enc, j_lens, jnp.asarray(to_np(ys_in)),
            jnp.asarray(ys_lens + 1), reverse)
        with torch.no_grad():
            t_logp = tm.decoder_logits(t_enc, t_lens, ys_in, t_ys_lens + 1,
                                       reverse=reverse)
        np.testing.assert_allclose(to_np(t_logp), to_np(j_logp), **TOL)


def test_bridge_refuses_unused_and_unfilled():
    _, _, flat, _ = tiny_models(0)
    model = build_asr_model(TINY_CONF, FEAT_DIM, VOCAB)
    extra = dict(flat)
    extra["params/encoder/encoders/layer_0/bogus/kernel"] = np.zeros((2, 2))
    with pytest.raises(KeyError, match="bogus"):
        flax_to_state_dict(extra, model)
    missing = {k: v for k, v in flat.items() if "after_norm" not in k}
    with pytest.raises(KeyError, match="no flax leaf fills"):
        flax_to_state_dict(missing, model)


def test_bridge_owns_the_depthwise_layout():
    """flax's depthwise Conv kernel [K, 1, C] becomes K3's taps [K, C]."""
    _, _, flat, tm = tiny_models(0)
    key = "params/encoder/encoders/layer_1/conv_module/depthwise_conv/kernel"
    w = tm.encoder.encoders.layer_1.conv_module.depthwise_conv.weight
    assert flat[key].shape == (15, 1, 64) and tuple(w.shape) == (15, 64)
    np.testing.assert_array_equal(to_np(w), flat[key][:, 0, :])


def test_unported_options_raise():
    """Every input layer and the no_pos encoding are ported: they build
    (tests/test_torch_subsampling.py holds them to JAX), and an input
    layer that exists in neither package raises. sequence_sharding is
    ported: it builds, and with no model group (apply_mesh gives none)
    the model computes what the plain one computes."""
    for key, value, attr in (("input_layer", "linear", "embed"),
                             ("pos_enc_layer_type", "no_pos", "pos_enc")):
        m = build_asr_model(dict(TINY_CONF, **{key: value}), FEAT_DIM, VOCAB)
        built = getattr(m.encoder.embed, "pos_enc") if attr == "pos_enc" \
            else m.encoder.embed
        assert type(built).__name__ == {
            "linear": "LinearNoSubsampling",
            "no_pos": "NoPositionalEncoding"}[value]
    with pytest.raises(KeyError, match="conv2d5"):
        build_asr_model(dict(TINY_CONF, input_layer="conv2d5"), FEAT_DIM,
                        VOCAB)
    _, _, _, tm = tiny_models(0)
    ts = build_asr_model(dict(TINY_CONF, sequence_sharding=True), FEAT_DIM,
                         VOCAB)
    ts.load_state_dict(tm.state_dict())
    assert ts.sequence_sharding and ts.encoder.encoders.time_shard is None
    feats, lens = _inputs()
    x, xl = torch.from_numpy(feats), torch.from_numpy(lens).long()
    ys = torch.tensor([[3, 5, 7, 9], [4, 6, -1, -1], [8, -1, -1, -1]])
    ys_lens = torch.tensor([4, 2, 1])
    ts.eval()
    with torch.no_grad():
        for a, b in ((tm.encode(x, xl)[0], ts.encode(x, xl)[0]),
                     (tm(x, xl, ys, ys_lens)["loss"],
                      ts(x, xl, ys, ys_lens)["loss"])):
            assert torch.equal(a, b)


def test_bfloat16_compute_keeps_float32_parameters():
    """compute_dtype bfloat16 casts float32 parameters at use; outputs
    stay float32 and near the float32 model (a loose check: bf16 keeps 8
    significant bits, measured 0.04 max abs on this model)."""
    _, _, _, tm = tiny_models(0)
    tb = build_asr_model(dict(TINY_CONF, compute_dtype="bfloat16"),
                         FEAT_DIM, VOCAB)
    tb.load_state_dict(tm.state_dict())
    assert all(p.dtype == torch.float32 for p in tb.parameters())
    feats, lens = _inputs()
    with torch.no_grad():
        outs = [m.ctc_log_probs(m.encode(torch.from_numpy(feats),
                                         torch.from_numpy(lens).long())[0])
                for m in (tm, tb)]
    assert outs[1].dtype == torch.float32
    np.testing.assert_allclose(to_np(outs[1]), to_np(outs[0]), atol=0.15)
