"""openeat_torch decode parity on the CPU: greedy, prefix beam and
attention rescoring against the JAX decode functions (tokens exactly
equal, scores within 1e-4), with openeat_tpu/decode/numpy_ref.py as a
second oracle."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openeat_tpu.decode import numpy_ref
from openeat_tpu.decode.ctc_greedy import ctc_greedy_search as jax_greedy
from openeat_tpu.decode.ctc_prefix_beam import \
    ctc_prefix_beam_search as jax_prefix_beam
from openeat_tpu.decode.rescoring import \
    attention_rescoring as jax_rescoring
from openeat_torch.decode.ctc_greedy import ctc_greedy_search
from openeat_torch.decode.ctc_prefix_beam import ctc_prefix_beam_search
from openeat_torch.decode.rescoring import attention_rescoring
from openeat_torch.utils.common import log_add, remove_duplicates_and_blank
from tests._torch_parity import FEAT_DIM, tiny_models, to_np

torch.set_num_threads(1)


def _log_probs(b, t, v, seed, sharpness=3.0, levels=None):
    """Peaky random CTC log-posteriors. `levels` quantizes the logits so
    that equal values, and so top-k ties, occur."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, v)) * sharpness
    logits[..., 0] += 1.5  # blank-heavy, like a trained CTC head
    if levels:
        logits = np.round(logits * levels) / levels
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lens = rng.integers(t // 2, t + 1, b)
    lens[0] = t
    return lp.astype(np.float32), lens.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_matches_jax_and_oracle(seed):
    lp, lens = _log_probs(4, 30, 12, seed)
    hyps, hyp_lens = ctc_greedy_search(torch.from_numpy(lp),
                                       torch.from_numpy(lens))
    j_hyps, j_lens = jax_greedy(jnp.asarray(lp), jnp.asarray(lens))
    np.testing.assert_array_equal(to_np(hyps), to_np(j_hyps))
    np.testing.assert_array_equal(to_np(hyp_lens), to_np(j_lens))
    for i in range(4):
        got = list(to_np(hyps[i, :hyp_lens[i]]))
        assert got == numpy_ref.ctc_greedy_ref(lp[i], int(lens[i]))
        assert got == remove_duplicates_and_blank(
            lp[i, :lens[i]].argmax(-1))


@pytest.mark.parametrize("seed,beam,max_len,levels", [
    (0, 4, 64, None),
    (1, 10, 64, None),
    (2, 5, 64, 2),      # quantized logits: top-k ties
    (3, 4, 3, None),    # prefixes hit max_hyp_len
], ids=["beam4", "beam10", "ties", "full_prefixes"])
def test_prefix_beam_matches_jax(seed, beam, max_len, levels):
    lp, lens = _log_probs(3, 25, 12, seed, levels=levels)
    pre, pre_lens, scores = ctc_prefix_beam_search(
        torch.from_numpy(lp), torch.from_numpy(lens), beam_size=beam,
        max_hyp_len=max_len)
    j_pre, j_lens, j_scores = jax_prefix_beam(
        jnp.asarray(lp), jnp.asarray(lens), beam_size=beam,
        max_hyp_len=max_len)
    np.testing.assert_array_equal(to_np(pre), to_np(j_pre))
    np.testing.assert_array_equal(to_np(pre_lens), to_np(j_lens))
    np.testing.assert_allclose(to_np(scores), to_np(j_scores), atol=1e-4,
                               rtol=1e-4)
    if max_len < 64 or levels:
        return
    for i in range(3):  # the dict-based oracle agrees on the best prefix
        ref = numpy_ref.ctc_prefix_beam_ref(lp[i], int(lens[i]), beam)
        assert tuple(to_np(pre[i, 0, :pre_lens[i, 0]])) == ref[0][0]
        np.testing.assert_allclose(float(scores[i, 0]), ref[0][1],
                                   atol=1e-4, rtol=1e-4)
    assert log_add([-float("inf")] * 2) == -float("inf")
    np.testing.assert_allclose(log_add([-1.0, -2.0]),
                               np.logaddexp(-1.0, -2.0), rtol=1e-12)


@pytest.mark.parametrize("reverse_weight,max_len", [
    (0.0, 12), (0.3, 12),
    (0.3, 3),   # every beam dies (-1e30) and reports len max_len + 1
], ids=["left", "left_right", "dead_beams"])
def test_attention_rescoring_matches_jax(reverse_weight, max_len):
    jm, variables, _, tm = tiny_models(0)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, 61, FEAT_DIM)).astype(np.float32)
    lens = np.array([61, 44], np.int32)
    with torch.no_grad():
        enc, enc_lens = tm.encode(torch.from_numpy(feats),
                                  torch.from_numpy(lens).long())
        lp = tm.ctc_log_probs(enc)
        nbest, nbest_lens, nbest_scores = ctc_prefix_beam_search(
            lp, enc_lens, beam_size=4, max_hyp_len=max_len)
        hyps, hyp_lens, best_scores, best = attention_rescoring(
            tm, enc, enc_lens, nbest, nbest_lens, nbest_scores,
            ctc_weight=0.5, reverse_weight=reverse_weight)
    j_nbest = jax_prefix_beam(jnp.asarray(to_np(lp)),
                              jnp.asarray(to_np(enc_lens)), beam_size=4,
                              max_hyp_len=max_len)
    for got, want in zip((nbest, nbest_lens), j_nbest):
        np.testing.assert_array_equal(to_np(got), to_np(want))
    rescore = jax.jit(partial(jax_rescoring, jm, ctc_weight=0.5,
                              reverse_weight=reverse_weight,
                              return_index=True))
    j_hyps, j_lens, j_scores, j_best = rescore(
        variables, jnp.asarray(to_np(enc)), jnp.asarray(to_np(enc_lens)),
        jnp.asarray(to_np(nbest), jnp.int32),
        jnp.asarray(to_np(nbest_lens), jnp.int32),
        jnp.asarray(to_np(nbest_scores)))
    np.testing.assert_array_equal(to_np(best), to_np(j_best))
    np.testing.assert_array_equal(to_np(hyps), to_np(j_hyps))
    np.testing.assert_array_equal(to_np(hyp_lens), to_np(j_lens))
    np.testing.assert_allclose(to_np(best_scores), to_np(j_scores),
                               atol=1e-4, rtol=1e-4)


def test_rescoring_uses_the_right_decoder_only_when_weighted():
    """reverse_weight 0 must not touch the right decoder's weights."""
    _, _, _, tm = tiny_models(0)
    rng = np.random.default_rng(6)
    enc = torch.from_numpy(rng.standard_normal((1, 9, 64)).astype(np.float32))
    lens = torch.tensor([9])
    hyps = torch.tensor([[[3, 4, -1], [5, -1, -1]]])
    hyp_lens = torch.tensor([[2, 1]])
    ctc = torch.tensor([[-1.0, -2.0]])
    with torch.no_grad():
        before = attention_rescoring(tm, enc, lens, hyps, hyp_lens, ctc)
        for p in tm.decoder.right_decoder.parameters():
            p.add_(1.0)
        after = attention_rescoring(tm, enc, lens, hyps, hyp_lens, ctc)
    assert torch.equal(before[2], after[2])
