"""openeat_torch's attention decode mode against the JAX package, on
the CPU, with the tiny Conformer of tests/_torch_parity.py (float32,
dropout 0):
- the KV-cache pieces: MultiHeadedAttention.project_q / project_kv /
  attend_cached, DecoderLayer.step and the model's decoder_init_cache /
  decoder_step over four positions, each within 1e-5 of JAX;
- decoder_step along a fixed prefix against the full decoder_logits;
- the cached beam search's tokens and lengths equal to JAX's
  attention_beam_search_cached (B=2, beam 4, max_steps 8,
  length_penalty 0 and 0.5), scores within 1e-4, and equal to the port's
  own full-prefix search;
- mask_finished_scores / mask_finished_preds and adaptive_max_steps on a
  grid;
- the emission times of greedy and prefix-beam search equal to JAX's.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openeat_tpu.decode import attention_beam as jax_beam
from openeat_tpu.decode.ctc_greedy import ctc_greedy_search as jax_greedy
from openeat_tpu.decode.ctc_prefix_beam import \
    ctc_prefix_beam_search as jax_prefix_beam
from openeat_tpu.models.asr_model import ASRModel
from openeat_tpu.utils import mask as jax_mask
from openeat_torch.decode import attention_beam
from openeat_torch.decode.ctc_greedy import ctc_greedy_search
from openeat_torch.decode.ctc_prefix_beam import ctc_prefix_beam_search
from openeat_torch.utils import mask
from tests._torch_parity import FEAT_DIM, VOCAB, tiny_models, to_np
from tests.test_torch_decode import _log_probs

torch.set_num_threads(1)
ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    jm, variables, _, tm = tiny_models(0, dropout_rate=0.0)
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((2, 61, FEAT_DIM)).astype(np.float32)
    lens = np.array([61, 40], np.int32)
    with torch.no_grad():
        enc, enc_lens = tm.encode(torch.from_numpy(feats),
                                  torch.from_numpy(lens).long())
    return dict(jm=jm, v=variables, tm=tm, enc=enc, enc_lens=enc_lens)


def _jax_layer(method):
    """Apply `method(layer, *args)` to the JAX left decoder's layer 0."""
    return lambda mdl, *a: method(
        mdl.decoder.left_decoder.decoders.layers[0], *a)


def test_attention_cache_helpers_match_jax(models):
    jm, v, tm = models["jm"], models["v"], models["tm"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    mem = rng.standard_normal((2, 9, 64)).astype(np.float32)
    mmask = np.arange(9)[None, None, :] < np.array([9, 5])[:, None, None]
    attn = tm.decoder.left_decoder.decoders.layer_0.src_attn
    with torch.no_grad():
        q = attn.project_q(torch.from_numpy(x))
        k, vv = attn.project_kv(torch.from_numpy(mem))
        ctx = attn.attend_cached(q, k, vv, torch.from_numpy(mmask))
    jq, jk, jv, jctx = jm.apply(v, jnp.asarray(x), jnp.asarray(mem),
                                jnp.asarray(mmask), method=_jax_layer(
        lambda layer, x, m, mm: (
            layer.src_attn.project_q(x), *layer.src_attn.project_kv(m),
            layer.src_attn.attend_cached(layer.src_attn.project_q(x),
                                         *layer.src_attn.project_kv(m),
                                         mm))))
    assert q.shape == (2, 3, 4, 16) and k.shape == (2, 9, 4, 16)
    for got, want in ((q, jq), (k, jk), (vv, jv), (ctx, jctx)):
        np.testing.assert_allclose(to_np(got), to_np(want), atol=ATOL)


def test_decoder_layer_step_matches_jax(models):
    jm, v, tm = models["jm"], models["v"], models["tm"]
    rng = np.random.default_rng(2)
    b, lmax, t = 2, 5, 9
    mem = rng.standard_normal((b, t, 64)).astype(np.float32)
    mmask = np.arange(t)[None, None, :] < np.array([9, 6])[:, None, None]
    layer = tm.decoder.left_decoder.decoders.layer_0
    sk = torch.zeros((b, lmax, 4, 16))
    sv = torch.zeros((b, lmax, 4, 16))
    jsk, jsv = jnp.zeros((b, lmax, 4, 16)), jnp.zeros((b, lmax, 4, 16))
    step = jax.jit(partial(jm.apply, method=_jax_layer(
        lambda layer, x, pos, sk, sv, m, mm: layer.step(
            x, pos, sk, sv, layer.init_cross_cache(m), mm))))
    with torch.no_grad():
        cross = layer.init_cross_cache(torch.from_numpy(mem))
        for pos in range(3):
            x = rng.standard_normal((b, 1, 64)).astype(np.float32)
            y, sk, sv = layer.step(torch.from_numpy(x), pos, sk, sv, cross,
                                   torch.from_numpy(mmask))
            jy, jsk, jsv = step(v, jnp.asarray(x), jnp.int32(pos), jsk, jsv,
                                jnp.asarray(mem), jnp.asarray(mmask))
            for got, want in ((y, jy), (sk, jsk), (sv, jsv)):
                np.testing.assert_allclose(to_np(got), to_np(want),
                                           atol=ATOL)


def test_decoder_step_matches_jax_and_the_full_decoder(models):
    jm, v, tm = models["jm"], models["v"], models["tm"]
    enc, enc_lens = models["enc"], models["enc_lens"]
    b, t = enc.shape[:2]
    tokens = np.array([[VOCAB - 1, 3, 7, 7, 12], [VOCAB - 1, 5, 0, 9, 2]])
    jcache = jm.apply(v, jnp.asarray(to_np(enc)), b, 6,
                      method=ASRModel.decoder_init_cache)
    jstep = jax.jit(partial(jm.apply, method=ASRModel.decoder_step),
                    static_argnums=(5,))
    with torch.no_grad():
        cache = tm.decoder_init_cache(enc, b, 6)
        np.testing.assert_allclose(to_np(cache["cross"][0][0]),
                                   to_np(jcache["cross"][0][0]), atol=ATOL)
        full = tm.decoder_logits(enc, enc_lens, torch.from_numpy(tokens),
                                 torch.full((b,), 5))
        for pos in range(4):
            lp, cache = tm.decoder_step(torch.from_numpy(tokens[:, pos]), pos,
                                        cache, enc_lens, t)
            jlp, jcache = jstep(v, jnp.asarray(tokens[:, pos]),
                                jnp.int32(pos), jcache,
                                jnp.asarray(to_np(enc_lens)), t)
            assert lp.dtype == torch.float32 and lp.shape == (b, VOCAB)
            np.testing.assert_allclose(to_np(lp), to_np(jlp), atol=ATOL)
            np.testing.assert_allclose(to_np(lp), to_np(full[:, pos]),
                                       atol=ATOL)
        for got, want in zip(cache["self_k"], jcache["self_k"]):
            np.testing.assert_allclose(to_np(got), to_np(want), atol=ATOL)


@pytest.mark.parametrize("length_penalty", [0.0, 0.5])
def test_cached_search_matches_jax_and_the_uncached_one(models,
                                                        length_penalty):
    jm, v, tm = models["jm"], models["v"], models["tm"]
    enc, enc_lens = models["enc"], models["enc_lens"]
    with torch.no_grad():
        hyps, lens, scores = attention_beam.attention_beam_search_cached(
            tm, enc, enc_lens, beam_size=4, max_steps=8,
            length_penalty=length_penalty)
        full = attention_beam.recognize(tm, enc, enc_lens, beam_size=4,
                                        max_steps=8, use_cache=False,
                                        length_penalty=length_penalty)
    j_hyps, j_lens, j_scores = jax_beam.attention_beam_search_cached(
        jm, v, jnp.asarray(to_np(enc)), jnp.asarray(to_np(enc_lens)),
        beam_size=4, max_steps=8, length_penalty=length_penalty)
    assert hyps.shape == (2, 8)
    np.testing.assert_array_equal(to_np(hyps), to_np(j_hyps))
    np.testing.assert_array_equal(to_np(lens), to_np(j_lens))
    np.testing.assert_allclose(to_np(scores), to_np(j_scores), atol=1e-4,
                               rtol=1e-4)
    for got, want in zip(full, (hyps, lens)):
        np.testing.assert_array_equal(to_np(got), to_np(want))


def test_mask_finished_and_adaptive_steps_match_jax():
    rng = np.random.default_rng(3)
    scores = rng.standard_normal((6, 4)).astype(np.float32)
    preds = rng.integers(0, 30, (6, 4))
    for flags in ([0, 0, 0, 0, 0, 0], [1, 0, 1, 0, 0, 1], [1] * 6):
        end = np.array(flags, bool)
        for eos_index in (0, 2):
            np.testing.assert_array_equal(
                to_np(mask.mask_finished_scores(torch.from_numpy(scores),
                                                torch.from_numpy(end),
                                                eos_index)),
                to_np(jax_mask.mask_finished_scores(
                    jnp.asarray(scores), jnp.asarray(end), eos_index)))
        np.testing.assert_array_equal(
            to_np(mask.mask_finished_preds(torch.from_numpy(preds),
                                           torch.from_numpy(end), 39)),
            to_np(jax_mask.mask_finished_preds(jnp.asarray(preds),
                                               jnp.asarray(end), 39)))
    for lens in ([], [0], [3, 9], [17, 2, 40], [100]):
        for cap in (None, 8, 30, 64):
            for kw in ({}, dict(factor=1.5, margin=2, bucket=4)):
                assert attention_beam.adaptive_max_steps(
                    torch.tensor(lens, dtype=torch.long), cap=cap, **kw) \
                    == jax_beam.adaptive_max_steps(np.array(lens), cap=cap,
                                                   **kw)


@pytest.mark.parametrize("seed,beam,levels", [(0, 4, None), (1, 10, None),
                                              (2, 5, 2)],
                         ids=["beam4", "beam10", "ties"])
def test_emission_times_match_jax(seed, beam, levels):
    lp, lens = _log_probs(3, 25, 12, seed, levels=levels)
    t_lp, t_lens = torch.from_numpy(lp), torch.from_numpy(lens)
    hyps, hyp_lens, times = ctc_greedy_search(t_lp, t_lens,
                                              return_times=True)
    j = jax_greedy(jnp.asarray(lp), jnp.asarray(lens), return_times=True)
    for got, want in zip((hyps, hyp_lens, times), j):
        np.testing.assert_array_equal(to_np(got), to_np(want))
    out = ctc_prefix_beam_search(t_lp, t_lens, beam_size=beam,
                                 max_hyp_len=12, return_times=True)
    j = jax_prefix_beam(jnp.asarray(lp), jnp.asarray(lens), beam_size=beam,
                        max_hyp_len=12, return_times=True)
    for i in (0, 1, 3):
        np.testing.assert_array_equal(to_np(out[i]), to_np(j[i]))
    np.testing.assert_allclose(to_np(out[2]), to_np(j[2]), atol=1e-4,
                               rtol=1e-4)
    assert len(ctc_prefix_beam_search(t_lp, t_lens, beam_size=beam)) == 3
