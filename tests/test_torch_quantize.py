"""openeat_torch/utils/quantize.py on the CPU against the JAX package's
utils/quantize.py, the same tiny Conformer's weights on both sides
(through the bridge):
- q and scale bit-equal to the QTensor leaves (transposed) at min_size
  1024 and 4096, the quantized modules exactly the QTensor paths, the
  widened weights bit-equal to maybe_dequantize(.., float32), and
  quantized_bytes equal to JAX's;
- the quantized encode, CTC log-probs and both decoders' log-probs
  within 1e-5 of JAX's quantized apply (float32);
- tokens of the four decode modes, and StreamingBatch's rescored finals
  and times, equal to JAX's on the quantized weights.
"""

import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from openeat_tpu.decode import attention_beam as jax_beam
from openeat_tpu.decode import streaming_batch as jax_streaming_batch
from openeat_tpu.decode.ctc_greedy import ctc_greedy_search as jax_greedy
from openeat_tpu.decode.ctc_prefix_beam import \
    ctc_prefix_beam_search as jax_prefix_beam
from openeat_tpu.decode.rescoring import \
    attention_rescoring as jax_rescoring
from openeat_tpu.models.asr_model import ASRModel
from openeat_tpu.utils.quantize import (QTensor, maybe_dequantize,
                                        quantize_params)
from openeat_tpu.utils.quantize import \
    quantized_bytes as jax_quantized_bytes
from openeat_torch.decode import attention_beam
from openeat_torch.decode.ctc_greedy import ctc_greedy_search
from openeat_torch.decode.ctc_prefix_beam import ctc_prefix_beam_search
from openeat_torch.decode.rescoring import attention_rescoring
from openeat_torch.decode.streaming_batch import StreamingBatch
from openeat_torch.modules.layers import Dense
from openeat_torch.utils.quantize import quantize_model, quantized_bytes
from tests._torch_parity import FEAT_DIM, VOCAB, tiny_models, to_np

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def models():
    jm, variables, _, tm = tiny_models(0)
    return jm, variables, tm


def _quantized(models, min_size=4096):
    jm, variables, tm = models
    return (jm, quantize_params(variables, min_size=min_size),
            quantize_model(copy.deepcopy(tm), min_size=min_size))


def _qtensors(tree) -> dict:
    """{port module path: QTensor} of a quantized flax tree."""
    return {".".join(path[1:-1]): leaf
            for path, leaf in traverse_util.flatten_dict(tree).items()
            if isinstance(leaf, QTensor)}


@pytest.mark.parametrize("min_size", [1024, 4096])
def test_leaves_and_bytes_match_jax(models, min_size):
    _, qv, tq = _quantized(models, min_size)
    jq = _qtensors(qv)
    denses = {n: m for n, m in tq.named_modules() if isinstance(m, Dense)}
    got = {n for n, m in denses.items() if m.q is not None}
    assert got == set(jq) and len(got) >= 10
    # every Dense left in float is below the size floor
    assert all(m.weight.numel() < min_size for n, m in denses.items()
               if n not in got)
    widened = {".".join(p[1:-1]): leaf for p, leaf in traverse_util
               .flatten_dict(maybe_dequantize(qv, jnp.float32)).items()}
    for name in got:
        m = denses[name]
        assert m.weight is None and m.q.dtype == torch.int8
        np.testing.assert_array_equal(to_np(m.q), np.asarray(jq[name].q).T)
        np.testing.assert_array_equal(to_np(m.scale),
                                      np.asarray(jq[name].scale))
        np.testing.assert_array_equal(to_np(m.dense_weight()),
                                      np.asarray(widened[name]).T)
    assert quantized_bytes(tq) == jax_quantized_bytes(qv)
    # the float32 model the copy came from is untouched
    assert all(m.q is None and m.weight is not None
               for m in models[2].modules() if isinstance(m, Dense))


def _encode_both(jm, qv, tq, seed=5):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((2, 61, FEAT_DIM)).astype(np.float32)
    lens = np.array([61, 44], np.int32)
    with torch.no_grad():
        enc, enc_lens = tq.encode(torch.from_numpy(feats),
                                  torch.from_numpy(lens).long())
    j_enc, j_lens = jax.jit(partial(jm.apply, method=ASRModel.encode))(
        qv, jnp.asarray(feats), jnp.asarray(lens))
    return enc, enc_lens, j_enc, j_lens


def test_quantized_forward_matches_jax(models):
    jm, qv, tq = _quantized(models)
    enc, enc_lens, j_enc, j_lens = _encode_both(jm, qv, tq)
    np.testing.assert_array_equal(to_np(enc_lens), to_np(j_lens))
    np.testing.assert_allclose(to_np(enc), to_np(j_enc), **TOL)
    # the rest on the same encoder rows
    j_in = jnp.asarray(to_np(enc))
    ys = np.array([[VOCAB - 1, 3, 7, 7, 12], [VOCAB - 1, 5, 1, 9, 2]])
    ys_lens = np.array([5, 3])
    with torch.no_grad():
        np.testing.assert_allclose(
            to_np(tq.ctc_log_probs(enc)),
            to_np(jm.apply(qv, j_in, method=ASRModel.ctc_log_probs)), **TOL)
        for reverse in (False, True):
            got = tq.decoder_logits(enc, enc_lens, torch.from_numpy(ys),
                                    torch.from_numpy(ys_lens), reverse)
            want = jm.apply(qv, j_in, jnp.asarray(to_np(enc_lens)),
                            jnp.asarray(ys), jnp.asarray(ys_lens), reverse,
                            method=ASRModel.decoder_logits)
            np.testing.assert_allclose(to_np(got), to_np(want), **TOL)
    # int8 changed the model: the float32 encoder differs
    with torch.no_grad():
        f_enc = models[2].encode(torch.from_numpy(
            np.random.default_rng(5).standard_normal(
                (2, 61, FEAT_DIM)).astype(np.float32)),
            torch.tensor([61, 44]))[0]
    assert not torch.equal(f_enc, enc)


def test_quantized_decode_modes_match_jax(models):
    """Each side from its own encoder output: greedy, prefix beam,
    attention (the cached search) and attention rescoring tokens."""
    jm, qv, tq = _quantized(models)
    enc, enc_lens, j_enc, j_lens = _encode_both(jm, qv, tq, seed=11)
    with torch.no_grad():
        lp = tq.ctc_log_probs(enc)
        greedy = ctc_greedy_search(lp, enc_lens)
        nbest = ctc_prefix_beam_search(lp, enc_lens, beam_size=4,
                                       max_hyp_len=16)
        rescored = attention_rescoring(tq, enc, enc_lens, *nbest,
                                       ctc_weight=0.5, reverse_weight=0.3)
        attn = attention_beam.recognize(tq, enc, enc_lens, beam_size=4,
                                        max_steps=8)
    j_lp = jm.apply(qv, j_enc, method=ASRModel.ctc_log_probs)
    j_greedy = jax_greedy(j_lp, j_lens)
    j_nbest = jax_prefix_beam(j_lp, j_lens, beam_size=4, max_hyp_len=16)
    j_rescored = jax.jit(partial(jax_rescoring, jm, ctc_weight=0.5,
                                 reverse_weight=0.3))(qv, j_enc, j_lens,
                                                      *j_nbest)
    j_attn = jax_beam.recognize(jm, qv, j_enc, j_lens, beam_size=4,
                                max_steps=8)
    for got, want in ((greedy, j_greedy), (nbest[:2], j_nbest[:2]),
                      (rescored[:2], j_rescored[:2]), (attn[:2], j_attn[:2])):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(to_np(g), to_np(w))
    assert int(to_np(greedy[1]).sum()) > 0


CHUNK, LEFT = 4, 2
STREAM_CONF = dict(d_model=32, attention_heads=2, linear_units=64,
                   cnn_module_kernel=5, causal=True, static_chunk_size=CHUNK,
                   num_left_chunks=LEFT, dropout_rate=0.0)
BKW = dict(chunk_size=CHUNK, num_left_chunks=LEFT, beam_size=5,
           max_hyp_len=24, enc_capacity=64)


def test_quantized_streaming_batch_matches_jax():
    """The rescored finals and times of two streams (min_size 1024, so
    the d=32 model's attention projections are int8 too)."""
    jm, variables, _, tm = tiny_models(5, **STREAM_CONF)
    qv = quantize_params(variables, min_size=1024)
    tq = quantize_model(tm, min_size=1024)
    assert len(_qtensors(qv)) >= 10
    rng = np.random.default_rng(3)
    wavs = [(rng.standard_normal(n) * 3000).astype(np.float32)
            for n in (14200, 9800)]
    got = {}
    for name, b in (("jax", jax_streaming_batch.StreamingBatch(
            jm, qv, slots=2, **BKW)), ("port", StreamingBatch(
                tq, slots=2, **BKW))):
        hs = [b.open() for _ in wavs]
        for h, w in zip(hs, wavs):
            b.accept(h, w)
        b.run_ready()
        finals = b.finish_many(hs, rescore=True, ctc_weight=0.5,
                               reverse_weight=0.3)
        got[name] = [(finals[h.slot], h.result_times_ms()) for h in hs]
    assert got["port"] == got["jax"]
    assert all(toks for toks, _ in got["port"])
