"""openeat_torch/decode/numpy_ref.py, the port's copy of the search
oracle, against openeat_tpu/decode/numpy_ref.py on the CPU:
- greedy: the same tokens;
- prefix beam at beams 4 and 10 and on quantized logits with top-k
  ties: the same prefixes in the same order, scores within 1e-12;
- attention_beam_ref over a seeded numpy scorer: the same hypotheses;
- the port's attention_beam_search and attention_beam_search_cached
  (the tiny Conformer of tests/_torch_parity.py) against the port's
  oracle scoring with the port's decoder;
- the module imports no jax and nothing of openeat_tpu.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from openeat_torch.decode import numpy_ref
from openeat_torch.decode.attention_beam import (
    attention_beam_search, attention_beam_search_cached,
    make_decoder_step_fn)
from openeat_torch.utils.common import IGNORE_ID
from openeat_tpu.decode import numpy_ref as jax_ref
from tests._torch_parity import FEAT_DIM, tiny_models, to_np
from tests.test_torch_decode import _log_probs

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_ref_matches_jax(seed):
    lp, lens = _log_probs(4, 30, 12, seed)
    for i in range(4):
        got = numpy_ref.ctc_greedy_ref(lp[i], int(lens[i]))
        assert got == jax_ref.ctc_greedy_ref(lp[i], int(lens[i]))
    assert numpy_ref.ctc_greedy_ref(lp[0], 30, blank_id=3) == \
        jax_ref.ctc_greedy_ref(lp[0], 30, blank_id=3)


@pytest.mark.parametrize("seed,beam,levels", [
    (0, 4, None),
    (1, 10, None),
    (2, 5, 2),     # quantized logits: top-k ties
    (3, 10, 1),
], ids=["beam4", "beam10", "ties_beam5", "ties_beam10"])
def test_prefix_beam_ref_matches_jax(seed, beam, levels):
    lp, lens = _log_probs(3, 25, 12, seed, levels=levels)
    if levels:  # the case holds ties among the top `beam` of a frame
        assert any(len(set(lp[i, t][np.argsort(lp[i, t])[::-1][:beam]]))
                   < beam for i in range(3) for t in range(lens[i]))
    for i in range(3):
        got = numpy_ref.ctc_prefix_beam_ref(lp[i], int(lens[i]), beam)
        want = jax_ref.ctc_prefix_beam_ref(lp[i], int(lens[i]), beam)
        assert [p for p, _ in got] == [p for p, _ in want]
        np.testing.assert_allclose([s for _, s in got],
                                   [s for _, s in want], rtol=0,
                                   atol=1e-12)
        assert len(got) == beam


def _seeded_scorer(vocab: int, eos: int, seed: int):
    """step_scores_fn whose log-probs for a prefix are drawn from an rng
    seeded by (seed, prefix): the same prefix gets the same row on every
    call, and eos is likely enough that hypotheses end."""
    def fn(prefixes):
        out = np.zeros((len(prefixes), vocab), np.float32)
        for i, p in enumerate(prefixes):
            logits = np.random.default_rng([seed] + list(p)).standard_normal(
                vocab) * 2.0
            logits[eos] += 0.3 * len(p)
            out[i] = logits - np.log(np.exp(logits).sum())
        return out
    return fn


@pytest.mark.parametrize("seed,batch,beam,max_steps", [
    (0, 2, 4, 8), (1, 3, 10, 12), (2, 1, 3, 20)])
def test_attention_beam_ref_matches_jax(seed, batch, beam, max_steps):
    vocab, sos, eos = 15, 14, 14
    fn = _seeded_scorer(vocab, eos, seed)
    got = numpy_ref.attention_beam_ref(fn, batch, beam, sos, eos, max_steps)
    want = jax_ref.attention_beam_ref(fn, batch, beam, sos, eos, max_steps)
    assert got == want
    assert len(got) == batch


@pytest.mark.parametrize("cached", [False, True], ids=["full", "cached"])
def test_port_attention_search_matches_port_oracle(cached):
    _, _, _, tm = tiny_models(0, dropout_rate=0.0)
    rng = np.random.default_rng(11)
    feats = rng.standard_normal((2, 61, FEAT_DIM)).astype(np.float32)
    beam, max_steps = 4, 8
    with torch.no_grad():
        enc, enc_lens = tm.encode(torch.from_numpy(feats),
                                  torch.tensor([61, 44]))
        if cached:
            hyps, lens, _ = attention_beam_search_cached(
                tm, enc, enc_lens, beam_size=beam, max_steps=max_steps)
        else:
            hyps, lens, _ = attention_beam_search(
                make_decoder_step_fn(tm), enc, enc_lens, beam_size=beam,
                sos=tm.sos, eos=tm.eos, max_steps=max_steps)

    def step_scores(prefixes):
        ln = max(len(p) for p in prefixes)
        arr = torch.full((len(prefixes), ln), tm.eos, dtype=torch.long)
        for i, p in enumerate(prefixes):
            arr[i, :len(p)] = torch.tensor(p)
        rep = len(prefixes) // enc.shape[0]
        with torch.no_grad():
            lp = tm.decoder_logits(
                torch.repeat_interleave(enc, rep, dim=0),
                torch.repeat_interleave(enc_lens, rep, dim=0), arr,
                torch.full((len(prefixes),), ln, dtype=torch.long))
        return np.stack([to_np(lp[i, len(p) - 1])
                         for i, p in enumerate(prefixes)])

    want = numpy_ref.attention_beam_ref(step_scores, enc.shape[0], beam,
                                        tm.sos, tm.eos, max_steps)
    for i in range(enc.shape[0]):
        got = [int(x) for x in to_np(hyps[i]) if x != IGNORE_ID]
        assert got == want[i], (got, want[i])
        assert int(lens[i]) == len(want[i])


def test_numpy_ref_imports_no_jax():
    code = (
        "import sys\n"
        "import openeat_torch.decode.numpy_ref\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'openeat_tpu'))\n"
        "print('LOADED', bad)\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout
