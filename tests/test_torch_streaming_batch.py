"""openeat_torch's batched streaming runtime and bin/stream_recognize on
the CPU, against the port's own single-stream runtime and the JAX
package.

The tiny causal, chunked Conformer of tests/test_torch_streaming.py
(2 blocks, d=32, 2 heads, kernel 5, chunk 4, 2 left chunks) with 1+1
decoders at reverse_weight 0.3, the same weights on both sides, float32:
- S interleaved streams with ragged arrivals give the greedy tokens of
  S sequential S = 1 runs, and encoder rows within atol 1e-5 /
  rtol 1e-4 (the batched matmuls sum in another order);
- the chunk-carried prefix beams finalize to the offline prefix search's
  n-best on the same encoder rows (tokens equal, scores within 1e-5);
- finish(rescore=True) gives JAX StreamingBatch's tokens and times on
  the same audio (each runtime with its own fbank, ROADMAP Queue 3 item
  3: the test asserts the margin between the winning and the second
  rescoring score exceeds 100x their measured gap);
- a reused slot decodes as a fresh one, and under "running"
  normalisation the result does not depend on how the audio arrived;
- the CLI writes JAX's result and timestamp files at --slots 1 greedy,
  --slots 2 rescoring and --slots 2 rescoring with --quantize int8, and
  refuses --device cuda without a card.
"""

import json

import numpy as np
import pytest
import torch

from openeat_tpu.bin import stream_recognize as jax_stream_recognize
from openeat_tpu.decode import streaming_batch as jax_streaming_batch
from openeat_tpu.decode.rescoring import \
    rescoring_scores as jax_rescoring_scores
from openeat_tpu.utils import checkpoint as jax_ckpt
from openeat_torch.bin import stream_recognize
from openeat_torch.decode.ctc_prefix_beam import (ctc_prefix_beam_search,
                                                  prefix_beam_finalize)
from openeat_torch.decode.rescoring import rescoring_scores
from openeat_torch.decode.streaming import StreamingRecognizer
from openeat_torch.decode.streaming_batch import StreamingBatch
from openeat_torch.ops.fbank import num_frames
from tests._torch_parity import TINY_CONF, VOCAB, tiny_models
from tests.make_tiny_data import build as build_tiny

torch.set_num_threads(1)
CHUNK, LEFT = 4, 2
CONF = dict(d_model=32, attention_heads=2, linear_units=64,
            cnn_module_kernel=5, causal=True, static_chunk_size=CHUNK,
            num_left_chunks=LEFT, dropout_rate=0.0)
KW = dict(chunk_size=CHUNK, num_left_chunks=LEFT)
BKW = dict(KW, beam_size=5, max_hyp_len=24, enc_capacity=64)


@pytest.fixture(scope="module")
def models():
    return tiny_models(5, **CONF)


def _wavs(seed, lens):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 3000).astype(np.float32)
            for n in lens]


def _t_total(n_samples: int) -> int:
    return ((num_frames(n_samples, 400, 160) - 1) // 2 - 1) // 2


def test_batch_matches_sequential(models):
    *_, tm = models
    wavs = _wavs(1, [16000, 11500, 15000, 7300])
    seq = []
    for w in wavs:
        sr = StreamingRecognizer(tm, collect_encoder_out=True, **KW)
        sr.accept_waveform(w)
        sr.finish()
        seq.append((sr.result(), np.concatenate(sr.enc_chunks)))
    batch = StreamingBatch(tm, slots=4, **BKW)
    handles = [batch.open() for _ in range(4)]
    cuts = [np.split(w, [1500, 5000, 9100]) for w in wavs]
    for r in range(4):   # ragged: uneven pieces, round-robin
        for h, pieces in zip(handles, cuts):
            if r < len(pieces):
                batch.accept(h, pieces[r])
        batch.run_ready()
    finals = batch.finish_many(handles, rescore=False)
    for i, h in enumerate(handles):
        assert finals[h.slot] == seq[i][0] and seq[i][0], i
        t = _t_total(len(wavs[i]))
        np.testing.assert_allclose(batch.encoder_out(h)[:t], seq[i][1][:t],
                                   atol=1e-5, rtol=1e-4)


def test_carried_beam_equals_offline_prefix_search(models):
    *_, tm = models
    wav = _wavs(2, [15000])[0]
    batch = StreamingBatch(tm, slots=2, **BKW)
    h = batch.open()
    batch.accept(h, wav)
    batch.run_ready()
    batch.finish(h, rescore=False)
    t = _t_total(len(wav))
    enc = torch.from_numpy(batch.encoder_out(h)[:t])[None]
    with torch.no_grad():
        lp = tm.ctc_log_probs(enc)
    nb, nl, ns = ctc_prefix_beam_search(lp, torch.tensor([t]), beam_size=5,
                                        max_hyp_len=24)
    bnb, bnl, bns = prefix_beam_finalize(
        batch.beam.rows(torch.tensor([h.slot])))
    assert torch.equal(bnb, nb) and torch.equal(bnl, nl)
    np.testing.assert_allclose(bns.numpy(), ns.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_rescored_finals_match_jax(models):
    jm, variables, _, tm = models
    wavs = _wavs(3, [14200, 9800])
    jb = jax_streaming_batch.StreamingBatch(jm, variables, slots=2, **BKW)
    tb = StreamingBatch(tm, slots=2, **BKW)
    got = {}
    for name, b in (("jax", jb), ("port", tb)):
        hs = [b.open() for _ in wavs]
        for h, w in zip(hs, wavs):
            b.accept(h, w)
        b.run_ready()
        finals = b.finish_many(hs, rescore=True, ctc_weight=0.5,
                               reverse_weight=0.3)
        got[name] = [(finals[h.slot], h.result_times_ms()) for h in hs]
    # the margin: the port's winning rescoring score against its second,
    # beside the gap between the two runtimes' scores of the same n-best
    for i, h in enumerate(hs):
        t = min(_t_total(len(wavs[i])), 64)
        nb, nl, ns = prefix_beam_finalize(
            tb.beam.rows(torch.tensor([h.slot])))
        enc = tb.enc_buf[h.slot:h.slot + 1, :64]
        with torch.no_grad():
            score = rescoring_scores(tm, enc, torch.tensor([t]), nb, nl, ns,
                                     ctc_weight=0.5, reverse_weight=0.3)[0]
        j_score = jax_rescoring_scores(
            jm, variables, enc.numpy(), np.array([t]), nb.numpy(),
            nl.numpy(), ns.numpy(), ctc_weight=0.5, reverse_weight=0.3)[0]
        top2 = score.topk(2).values
        gap = float(np.abs(score.numpy() - np.asarray(j_score)).max())
        assert float(top2[0] - top2[1]) > 100 * gap
    assert got["port"] == got["jax"]
    assert all(toks for toks, _ in got["port"])


def test_slot_reuse_is_clean(models):
    *_, tm = models
    wav_a, wav_b = _wavs(4, [12000, 9000])
    batch = StreamingBatch(tm, slots=1, **BKW)
    runs = []
    for wav in (wav_a, wav_b, wav_a):
        h = batch.open()
        batch.accept(h, wav)
        batch.run_ready()
        runs.append((batch.finish(h, rescore=True, reverse_weight=0.3),
                     h.result_times_ms(), batch.encoder_out(h)))
        if len(runs) < 3:
            batch.close(h)
    assert runs[2][0] == runs[0][0] and runs[2][1] == runs[0][1]
    np.testing.assert_array_equal(runs[2][2], runs[0][2])
    with pytest.raises(RuntimeError):
        batch.open()   # the third stream still holds the only slot


def test_result_does_not_depend_on_arrival(models):
    *_, tm = models
    wav = _wavs(9, [13000])[0]

    def run(pieces, step_each):
        batch = StreamingBatch(tm, slots=2, normalization="running", **BKW)
        h = batch.open()
        for p in pieces:
            batch.accept(h, p)
            if step_each:
                batch.run_ready()
        return batch.finish(h, rescore=True, ctc_weight=0.5)

    def split(n):
        return [wav[i: i + n] for i in range(0, len(wav), n)]

    runs = [run(split(2400), True), run(split(2400), False), run([wav], False),
            run(split(5100), True)]
    assert all(r == runs[0] for r in runs) and runs[0]


# ------------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory, models):
    jm, variables, flat, _ = models
    root = tmp_path_factory.mktemp("stream_cli")
    data = build_tiny(str(root / "data"), n_utts=6, seed=3, min_dur=0.5,
                      max_dur=1.2)
    assert data["vocab_size"] <= VOCAB
    npz = str(root / "model.npz")
    np.savez(npz, **flat)
    jax_ckpt.save_checkpoint(str(root), "jax_ckpt", variables)
    cfg = {"model_conf": dict(TINY_CONF, **CONF), "vocab_size": VOCAB,
           "collate_conf": {"normalization": True}}
    cfg_path = str(root / "train.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    return dict(root=root, data=data, npz=npz, cfg=cfg_path,
                jax_ckpt=str(root / "jax_ckpt"))


def _cli_args(s, ckpt, tag, extra):
    return ["--config", s["cfg"], "--checkpoint", ckpt, "--test_data",
            s["data"]["manifest"], "--dict", s["data"]["dict"],
            "--result_file", str(s["root"] / f"{tag}.txt"),
            "--timestamp_file", str(s["root"] / f"{tag}.jsonl"),
            "--chunk_size", "4", "--num_left_chunks", "2", "--piece_ms",
            "150", "--enc_capacity", "64", *extra]


@pytest.mark.parametrize("extra", [
    ["--final_mode", "ctc_greedy_search"],
    ["--slots", "2", "--final_mode", "attention_rescoring",
     "--reverse_weight", "0.3", "--beam_size", "5"],
    ["--quantize", "int8", "--slots", "2", "--final_mode",
     "attention_rescoring", "--reverse_weight", "0.3", "--beam_size", "5"],
], ids=["slots1_greedy", "slots2_rescoring", "slots2_rescoring_int8"])
def test_stream_recognize_writes_the_jax_files(cli_setup, extra):
    s = cli_setup
    tag = "_".join(extra[:2]).strip("-")
    stats = stream_recognize.main(_cli_args(s, s["npz"], "port" + tag, extra)
                                  + ["--device", "cpu"])
    jax_stream_recognize.main(_cli_args(s, s["jax_ckpt"], "jax" + tag,
                                        extra))
    for ext in ("txt", "jsonl"):
        with open(s["root"] / f"port{tag}.{ext}", encoding="utf-8") as f:
            port = f.read()
        with open(s["root"] / f"jax{tag}.{ext}", encoding="utf-8") as f:
            assert port == f.read(), ext
    rows = [json.loads(line) for line in port.splitlines()]
    assert {r["key"] for r in rows} == set(s["data"]["texts"])
    assert any(r["tokens"] for r in rows)
    assert stats["utts"] == len(s["data"]["texts"])


@pytest.mark.parametrize("extra,exc,match", [
    ([], RuntimeError, "--device cpu"),
], ids=["cuda_without_a_card"])
def test_refusals(cli_setup, monkeypatch, extra, exc, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(exc, match=match):
        stream_recognize.main(_cli_args(cli_setup, cli_setup["npz"],
                                        "refused", extra))
