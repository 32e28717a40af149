"""openeat_torch streaming against the JAX package, on the CPU.

A tiny causal, chunked Conformer (2 blocks, d=32, 2 heads, FFN 64,
kernel 5, rel_pos, conv2d, 1+1 decoders, static chunk 4 with 2 left
chunks) gets the same weights in both packages through the bridge;
float32, dropout 0 (eval). Tolerances:
- the chunk masks are bit-equal to JAX's;
- the position rows within 1e-6 of JAX's (sin and cos differ in the
  last bit), and a row's table equal to the batched one's;
- module outputs (subsampling with an offset, the conv module with its
  cache, attention and encoder-layer forward_chunk, encode_chunk and its
  new caches) within atol 1e-5 / rtol 1e-4 of JAX's (summation order);
- the streamed encoder equals the port's own offline chunk-masked
  encoder within rtol 1e-3 / atol 2e-4, JAX's contract
  (tests/test_streaming.py), and the streamed greedy partial equals the
  offline greedy result on the covered prefix;
- StreamingRecognizer's tokens and times equal JAX's on awkward piece
  splits. Both runtimes run their own fbank: the port's framed fbank is
  within 3e-4 of JAX's (ROADMAP Queue 3 item 3), so the two runtimes'
  CTC log-probs are held within 2e-3, and the test asserts that no
  frame's top-2 margin is within twice their measured gap, the margin
  that makes equal tokens a requirement and not luck;
- HostFrontend frames within 3e-4 of JAX's, the running statistics
  within 1e-4 relative after they fold the same frames;
- endpoint decisions equal JAX's on token paths drawn from a seed;
- the dynamic-chunk training loss within 1e-5 relative and every
  gradient within 1e-4 of its tensor's max |grad| (+1e-7 of the model's)
  of JAX's at a chunk size JAX's draw is made to give.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openeat_tpu.decode import endpoint as jax_endpoint
from openeat_tpu.decode import streaming as jax_streaming
from openeat_tpu.models.asr_model import ASRModel
from openeat_tpu.utils import mask as jax_mask
from openeat_tpu.utils.checkpoint import _flatten
from openeat_torch.decode.ctc_greedy import ctc_greedy_search
from openeat_torch.decode.endpoint import EndpointConfig, Endpointer
from openeat_torch.decode.streaming import HostFrontend, StreamingRecognizer
from openeat_torch.modules.dropout import set_generator
from openeat_torch.ops.fbank import fbank, num_frames
from openeat_torch.utils import mask
from openeat_torch.utils.common import make_generator
from openeat_torch.utils.param_bridge import flax_to_state_dict
from tests._torch_parity import FEAT_DIM, VOCAB, tiny_models, to_np

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-4)
STREAM_TOL = dict(rtol=1e-3, atol=2e-4)
LP_TOL = 2e-3   # CTC log-probs of the two runtimes, each with its fbank
CHUNK, LEFT = 4, 2
STREAM_CONF = dict(d_model=32, attention_heads=2, linear_units=64,
                   cnn_module_kernel=5, causal=True,
                   static_chunk_size=CHUNK, num_left_chunks=LEFT,
                   dropout_rate=0.0)


@pytest.fixture(scope="module")
def models():
    jm, variables, flat, tm = tiny_models(3, **STREAM_CONF)
    return jm, variables, flat, tm


def _wav(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 3000).astype(np.float32)


def _feats(wav: np.ndarray):
    feats, flens = fbank(torch.from_numpy(wav)[None],
                         torch.tensor([len(wav)]), num_mel_bins=FEAT_DIM)
    return feats, flens


# ---------------------------------------------------------------- masks

@pytest.mark.parametrize("size", [1, 5, 8, 17])
def test_chunk_masks_equal_jax(size):
    for cs in (1, 2, 4, 7, 25):
        for left in (-1, 0, 1, 3):
            want = np.asarray(jax_mask.chunk_mask(size, cs, left))
            np.testing.assert_array_equal(
                mask.chunk_mask(size, cs, left).numpy(), want)
            np.testing.assert_array_equal(
                mask.dynamic_chunk_mask(size, torch.tensor(cs),
                                        torch.tensor(left)).numpy(), want)
    # a drawn size of 0 is clamped to 1, as in JAX
    np.testing.assert_array_equal(
        mask.dynamic_chunk_mask(size, torch.tensor(0)).numpy(),
        np.asarray(jax_mask.dynamic_chunk_mask(size, jnp.int32(0))))


# ---------------------------------------------------------- the modules

def test_subsampling_offset_matches_jax(models):
    jm, variables, _, tm = models
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 23, FEAT_DIM)).astype(np.float32)
    lens = np.array([23, 23, 23])

    def embed(m, xs, ls, offset):
        return m.encoder.embed(xs, ls, offset=offset)

    offsets = [0, 9, -8]
    with torch.no_grad():
        t_x, t_pe, _ = tm.encoder.embed(torch.from_numpy(x),
                                        torch.from_numpy(lens),
                                        torch.tensor(offsets))
    assert t_pe.shape[0] == 3
    for i, off in enumerate(offsets):
        j_x, j_pe, _ = jm.apply(variables, jnp.asarray(x[i:i + 1]),
                                jnp.asarray(lens[:1]), off, method=embed)
        with torch.no_grad():
            s_x, s_pe, _ = tm.encoder.embed(torch.from_numpy(x[i:i + 1]),
                                            torch.from_numpy(lens[:1]), off)
        np.testing.assert_allclose(to_np(s_x), to_np(j_x), **TOL)
        # sin and cos of XLA and of torch differ in the last bit
        np.testing.assert_allclose(to_np(s_pe), to_np(j_pe), atol=1e-6)
        np.testing.assert_array_equal(to_np(t_pe[i:i + 1]), to_np(s_pe))
        np.testing.assert_allclose(to_np(t_x[i:i + 1]), to_np(j_x), **TOL)
        assert np.isfinite(to_np(t_pe)).all()


def _layer(m, idx=0):
    return m.encoder.encoders.layers[idx]


def test_conv_module_cache_matches_jax(models):
    jm, variables, _, tm = models
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    cache = rng.standard_normal((2, 4, 32)).astype(np.float32)

    def conv(m, xs, c):
        return _layer(m).conv_module(xs, None, c)

    j_y, j_c = jm.apply(variables, jnp.asarray(x), jnp.asarray(cache),
                        method=conv)
    mod = tm.encoder.encoders.layer_0.conv_module
    with torch.no_grad():
        y, c = mod(torch.from_numpy(x), None, torch.from_numpy(cache))
        offline = mod(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(y), to_np(j_y), **TOL)
    np.testing.assert_allclose(to_np(c), to_np(j_c), **TOL)
    # the new cache is a tensor of its own, not a view of the chunk
    assert c.is_contiguous() and c._base is None
    # a zero cache is the offline causal padding
    with torch.no_grad():
        y0, _ = mod(torch.from_numpy(x), None, torch.zeros(2, 4, 32))
    np.testing.assert_allclose(to_np(y0), to_np(offline), **TOL)


def _chunk_inputs(seed, b=2, tc=4, lc=8, d=32, h=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, tc, d)).astype(np.float32)
    kc = rng.standard_normal((b, lc, h, d // h)).astype(np.float32)
    vc = rng.standard_normal((b, lc, h, d // h)).astype(np.float32)
    kv_mask = np.ones((b, 1, lc + tc), bool)
    kv_mask[0, 0, :5] = False     # row 0: 3 valid cache slots
    kv_mask[1, 0, -1] = False     # row 1: a short final chunk
    pos = rng.standard_normal((1, lc + tc, d)).astype(np.float32)
    return x, kc, vc, kv_mask, pos


def test_attention_forward_chunk_matches_jax(models):
    jm, variables, _, tm = models
    x, kc, vc, kv_mask, pos = _chunk_inputs(3)

    def attn(m, *a):
        return _layer(m).self_attn.forward_chunk(*a)

    attn_t = tm.encoder.encoders.layer_0.self_attn
    # one table per row (JAX's method splits pos_emb into x's rows)
    rows = np.concatenate([pos, pos[:, ::-1]])
    j = jm.apply(variables, *map(jnp.asarray, (x, kc, vc, kv_mask, rows)),
                 method=attn)
    with torch.no_grad():
        t = attn_t.forward_chunk(*map(torch.from_numpy,
                                      (x, kc, vc, kv_mask, rows)))
        shared = attn_t.forward_chunk(*map(torch.from_numpy,
                                           (x, kc, vc, kv_mask, pos)))
        expanded = attn_t.forward_chunk(*map(torch.from_numpy, (
            x, kc, vc, kv_mask, np.concatenate([pos, pos]))))
    for got, want in zip(t, j):
        np.testing.assert_allclose(to_np(got), to_np(want), **TOL)
    # a [1, L, D] table serves every row
    for got, want in zip(shared, expanded):
        np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


def test_encoder_layer_forward_chunk_matches_jax(models):
    jm, variables, _, tm = models
    x, kc, vc, kv_mask, pos = _chunk_inputs(4)
    pos = np.concatenate([pos, pos])
    cnn = np.random.default_rng(5).standard_normal((2, 4, 32)).astype(
        np.float32)

    def layer(m, *a):
        return _layer(m, 1).forward_chunk(*a)

    j = jm.apply(variables, *map(jnp.asarray, (x, kc, vc, kv_mask, cnn,
                                               pos)), method=layer)
    with torch.no_grad():
        t = tm.encoder.encoders.layer_1.forward_chunk(
            *map(torch.from_numpy, (x, kc, vc, kv_mask, cnn, pos)))
    for got, want in zip(t, j):
        np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


def _caches(seed, b, lc, n=2, h=2, dk=16, k=5, d=32):
    rng = np.random.default_rng(seed)
    kv = [rng.standard_normal((b, lc, h, dk)).astype(np.float32)
          for _ in range(2 * n)]
    cnn = [rng.standard_normal((b, k - 1, d)).astype(np.float32)
           for _ in range(n)]
    return kv[:n], kv[n:], cnn


@pytest.mark.parametrize("offset,cache_len,valid", [
    (0, 0, 4), (4, 4, 4), (20, 8, 2)], ids=["first", "second", "final"])
def test_encode_chunk_matches_jax(models, offset, cache_len, valid):
    jm, variables, _, tm = models
    rng = np.random.default_rng(6)
    win = rng.standard_normal((1, 4 * CHUNK + 3, FEAT_DIM)).astype(np.float32)
    kc, vc, cnn = _caches(7, 1, LEFT * CHUNK)
    j = jm.apply(variables, jnp.asarray(win), jnp.int32(offset),
                 tuple(map(jnp.asarray, kc)), tuple(map(jnp.asarray, vc)),
                 jnp.int32(cache_len), tuple(map(jnp.asarray, cnn)),
                 jnp.int32(valid), method=ASRModel.encode_chunk)
    t = tm.encode_chunk(torch.from_numpy(win), offset,
                        [torch.from_numpy(a) for a in kc],
                        [torch.from_numpy(a) for a in vc], cache_len,
                        [torch.from_numpy(a) for a in cnn], valid)
    np.testing.assert_allclose(to_np(t[0]), to_np(j[0]), **TOL)
    for got, want in zip(t[1:], j[1:]):
        for g, w in zip(got, want):
            np.testing.assert_allclose(to_np(g), to_np(w), **TOL)


def test_encode_chunk_per_row_values_equal_single_rows(models):
    """Offsets, cache lengths and valid lengths as tensors [B]: each row
    equals its own S = 1 call (the batched runtime's contract)."""
    _, _, _, tm = models
    rng = np.random.default_rng(8)
    win = torch.from_numpy(rng.standard_normal(
        (3, 4 * CHUNK + 3, FEAT_DIM)).astype(np.float32))
    kc, vc, cnn = (list(map(torch.from_numpy, a))
                   for a in _caches(9, 3, LEFT * CHUNK))
    offs, clens, valids = [0, 4, 36], [0, 4, 8], [4, 4, 1]
    out = tm.encode_chunk(win, torch.tensor(offs), kc, vc,
                          torch.tensor(clens), cnn, torch.tensor(valids))
    for i in range(3):
        one = tm.encode_chunk(win[i:i + 1], offs[i],
                              [a[i:i + 1] for a in kc],
                              [a[i:i + 1] for a in vc], clens[i],
                              [a[i:i + 1] for a in cnn], valids[i])
        np.testing.assert_allclose(to_np(out[0][i:i + 1]), to_np(one[0]),
                                   **TOL)
        for got, want in zip(out[1:], one[1:]):
            for g, w in zip(got, want):
                np.testing.assert_allclose(to_np(g[i:i + 1]), to_np(w),
                                           **TOL)


def test_offline_chunked_encoder_and_bridge_match_jax(models):
    """The causal, chunked model's tree carries through the bridge
    unchanged (strict load, no new parameters), and its offline
    chunk-masked encode equals JAX's."""
    jm, variables, flat, tm = models
    assert set(flax_to_state_dict(flat, tm)) == set(tm.state_dict())
    wav = _wav(10, 16000)
    feats, flens = _feats(wav)
    j_enc, _ = jm.apply(variables, jnp.asarray(feats.numpy()),
                        jnp.asarray(flens.numpy()), method=ASRModel.encode)
    t_enc, _ = tm.encode(feats, flens)
    np.testing.assert_allclose(to_np(t_enc), to_np(j_enc), **TOL)


# ------------------------------------------------------------- streaming

@pytest.mark.parametrize("n_samp,cuts", [
    (16000, [1500, 5000, 5100, 9000, 12000]),
    (15000, [1500, 5000, 9100, 12000]),
], ids=["pieces", "flush_tail"])
def test_streamed_encoder_equals_offline_chunked(models, n_samp, cuts):
    _, _, _, tm = models
    wav = _wav(11, n_samp)
    nf = num_frames(n_samp, 400, 160)
    t_total = ((nf - 1) // 2 - 1) // 2
    feats, flens = _feats(wav)
    enc_full, _ = tm.encode(feats, flens)
    sr = StreamingRecognizer(tm, chunk_size=CHUNK, num_left_chunks=LEFT,
                             collect_encoder_out=True)
    for p in np.split(wav, cuts):
        sr.accept_waveform(p)
    if n_samp == 15000:
        assert t_total % CHUNK
        sr.finish()
        t_cov = t_total
        assert sr.finish() == []
    else:
        t_cov = sr.offset
        assert t_cov // CHUNK >= 4
    streamed = np.concatenate(sr.enc_chunks)[:t_cov]
    np.testing.assert_allclose(streamed, to_np(enc_full[0, :t_cov]),
                               **STREAM_TOL)
    lp = tm.ctc_log_probs(enc_full[:, :t_cov])
    hyps, lens = ctc_greedy_search(lp, torch.tensor([t_cov]))
    assert sr.result() == hyps[0, :lens[0]].tolist()
    with pytest.raises(RuntimeError):
        sr.finish()
        sr.accept_waveform(wav[:100])


@pytest.mark.parametrize("normalization", ["none", "running"])
def test_streaming_recognizer_matches_jax(models, normalization):
    jm, variables, _, tm = models
    wav = _wav(12, 22000)
    cuts = [1500, 5000, 5100, 9000, 12000, 17777]
    jsr = jax_streaming.StreamingRecognizer(
        jm, variables, chunk_size=CHUNK, num_left_chunks=LEFT,
        normalization=normalization, collect_encoder_out=True)
    sr = StreamingRecognizer(tm, chunk_size=CHUNK, num_left_chunks=LEFT,
                             normalization=normalization,
                             collect_encoder_out=True)
    partial_j, partial_t = [], []
    for p in np.split(wav, cuts):
        partial_j.append(jsr.accept_waveform(p))
        partial_t.append(sr.accept_waveform(p))
    partial_j.append(jsr.finish())
    partial_t.append(sr.finish())
    # the two fbanks differ by rounding (see the module text): the CTC
    # log-probs stay within LP_TOL, and no frame's top-2 margin is
    # within twice the measured gap, so no argmax can differ
    with torch.no_grad():
        lp, j_lp = (tm.ctc_log_probs(torch.from_numpy(np.concatenate(c)))
                    for c in (sr.enc_chunks, jsr.enc_chunks))
    gap = float((lp - j_lp).abs().max())
    top2 = lp.topk(2, dim=-1).values
    assert gap <= LP_TOL
    assert float((top2[:, 0] - top2[:, 1]).min()) > 2 * gap
    assert partial_t == partial_j
    assert sr.result() == jsr.result() and sr.result()
    assert sr.result_times_ms() == jsr.result_times_ms()
    assert sr.endpoint_detected() == jsr.endpoint_detected()


def test_host_frontend_matches_jax():
    rng = np.random.default_rng(13)
    fe = HostFrontend(FEAT_DIM, 16000, "running")
    jfe = jax_streaming.HostFrontend(FEAT_DIM, 16000, "running")
    f0, win, stride = 0, 19, 16
    for n in (3200, 700, 9000, 40, 5000, 3200):   # a 512-frame backlog too
        wav = (rng.standard_normal(n) * 3000).astype(np.float32)
        fe.accept(wav)
        jfe.accept(wav)
        assert fe.n_frames == jfe.n_frames and fe.n_samples == jfe.n_samples
        np.testing.assert_allclose(fe.frames, jfe.frames, atol=3e-4,
                                   rtol=0)
        while fe.n_frames - f0 >= win:
            got, want = fe.window(f0, win), jfe.window(f0, win)
            np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
            assert fe._nn == jfe._nn
            np.testing.assert_allclose(fe._nsum, jfe._nsum, rtol=1e-4)
            np.testing.assert_allclose(fe._nsumsq, jfe._nsumsq, rtol=1e-4)
            f0 += stride
    fe.flush_tail()
    jfe.flush_tail()
    assert fe.n_frames == jfe.n_frames and fe.t_total() == jfe.t_total()
    np.testing.assert_allclose(fe.frames, jfe.frames, atol=3e-4, rtol=0)
    # the buffers were trimmed as JAX's were
    assert len(fe.samples) == len(jfe.samples)
    assert fe.frames.shape == jfe.frames.shape


def test_endpoint_rules_match_jax():
    cfg = dict(rule1_min_trailing_silence=400.0,
               rule2_min_trailing_silence=200.0,
               rule3_min_utterance_length=1200.0)
    rng = np.random.default_rng(14)
    for trial in range(40):
        ep = Endpointer(EndpointConfig(**cfg), frame_ms=40.0)
        jep = jax_endpoint.Endpointer(jax_endpoint.EndpointConfig(**cfg),
                                      frame_ms=40.0)
        p_blank = rng.uniform(0.3, 1.0)
        for _ in range(8):
            toks = np.where(rng.random(4) < p_blank, 0,
                            rng.integers(1, 9, 4)).tolist()
            assert ep.feed(toks) == jep.feed(toks), (trial, toks)
            assert (ep.trailing_blanks, ep.spoke, ep.n_frames) == (
                jep.trailing_blanks, jep.spoke, jep.n_frames)
    # each rule on its own, at the default thresholds
    for toks, want in (([0] * 124, False), ([0] * 125, True),
                       ([3] + [0] * 24, False), ([3] + [0] * 25, True),
                       ([3, 4] * 249 + [5], False), ([3, 4] * 250, True)):
        ep = Endpointer()
        assert ep.feed(toks) == want
        if want:   # latched: speech after the endpoint does not undo it
            assert ep.feed([7]) and ep.detected


# ------------------------------------------------- dynamic-chunk training

def _train_batch(seed=15):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((2, 64, FEAT_DIM)).astype(np.float32)
    lens = np.array([64, 40], np.int32)
    ys = rng.integers(1, VOCAB - 1, (2, 5)).astype(np.int32)
    ys_lens = np.array([5, 3], np.int32)
    ys[1, 3:] = -1
    return feats, lens, ys, ys_lens


@pytest.mark.parametrize("u", [3, 9, 14], ids=["cs4", "cs10", "full"])
def test_dynamic_chunk_training_matches_jax(monkeypatch, u):
    """JAX's draw is made to give u (T' = 15 here): cs = T' when
    u > T' // 2, else u % 25 + 1; the port gets that chunk size."""
    conf = dict(STREAM_CONF, static_chunk_size=0, num_left_chunks=1,
                use_dynamic_chunk=True)
    jm, variables, _, tm = tiny_models(3, **conf)
    batch = _train_batch()
    t = ((64 - 1) // 2 - 1) // 2
    cs = t if u > t // 2 else u % 25 + 1
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.int32(u))

    def loss_fn(v):
        m = jm.apply(v, *map(jnp.asarray, batch), deterministic=False,
                     rngs={"dropout": jax.random.PRNGKey(0)})
        return m["loss"], m

    (_, j_m), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(variables)
    tm.train()
    m = tm(*map(torch.from_numpy, batch), chunk_size=cs)
    m["loss"].backward()
    for key in ("loss", "loss_ctc", "loss_att"):
        np.testing.assert_allclose(m[key].item(), float(j_m[key]),
                                   rtol=1e-5, err_msg=key)
    want = flax_to_state_dict(_flatten(j_grads), tm)
    g_max = max(float(g.abs().max()) for g in want.values())
    for name, p in tm.named_parameters():
        ref = want[name].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max() + 1e-7 * g_max, (name, err)


def test_dynamic_chunk_draw_comes_from_the_generator():
    """In training the chunk size is drawn from the generator
    set_generator hands the model (the same draw twice from one seed,
    and the formula's chunk size); eval stays full context."""
    conf = dict(STREAM_CONF, static_chunk_size=0, use_dynamic_chunk=True)
    _, _, _, tm = tiny_models(3, **conf)
    batch = [torch.from_numpy(a) for a in _train_batch()]
    t = ((64 - 1) // 2 - 1) // 2
    tm.train()
    with pytest.raises(RuntimeError, match="generator"):
        tm(*batch)
    losses = {}
    for seed in range(4):
        set_generator(tm, make_generator(seed))
        got = float(tm(*batch)["loss"])
        u = int(torch.randint(1, t, (), generator=make_generator(seed)))
        cs = t if u > t // 2 else u % 25 + 1
        np.testing.assert_allclose(got, float(tm(*batch, chunk_size=cs)
                                              ["loss"]), rtol=1e-6)
        set_generator(tm, make_generator(seed))
        assert float(tm(*batch)["loss"]) == got
        losses[seed] = got
    assert len(set(losses.values())) > 1
    tm.eval()
    full = float(tm(*batch)["loss"])
    assert float(tm(*batch)["loss"]) == full
    with pytest.raises(ValueError, match="chunk_size"):
        tm(*batch, chunk_size=4)
