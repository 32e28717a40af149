"""openeat_torch's serving runtime (runtime/server.py, runtime/client.py,
bin/serve.py) on the CPU, against the JAX package's server and the
port's own StreamingBatch.

The tiny causal, chunked Conformer of tests/test_torch_streaming_batch.py
(d=32, 2 blocks, chunk 4 with 2 left chunks, 1+1 decoders), the same
weights in both packages, float32; both servers on 127.0.0.1, port 0,
in this process:
- 4 concurrent clients on 2 slots (so two wait for admission): every
  final event's JSON is byte-equal to the JAX server's for the same
  audio, and its tokens and times are a direct float16 StreamingBatch
  run's; partials concatenate to a prefix of the direct greedy path;
- the test_server.py contract: end without audio, slot recycling;
- the wire both ways (the port's client on the JAX server, the JAX
  client on the port's server), an 8 kHz client, server-side
  endpointing with a short rule 3, and the error events of an unknown
  op, a bad frame kind and admission overflow;
- bin/serve's flags are the JAX entry point's plus --device, cuda
  without a card raises, and --quantize int8 --device cpu serves the
  JAX serve's int8 finals;
- StreamingBatch's default transfer dtype is float32 and leaves the
  windows as they are; float16 rounds them and equals JAX's float16.
Every socket has a timeout, every join is bounded, every server stops.
"""

import json
import socket
import threading

import numpy as np
import pytest
import torch

from openeat_tpu.bin import serve as jax_serve
from openeat_tpu.decode import streaming_batch as jax_streaming_batch
from openeat_tpu.runtime import client as jax_client
from openeat_tpu.runtime import server as jax_server
from openeat_tpu.utils import checkpoint as jax_ckpt
from openeat_torch.bin import serve
from openeat_torch.dataset.audio import resample
from openeat_torch.decode.endpoint import EndpointConfig
from openeat_torch.decode.streaming_batch import StreamingBatch
from openeat_torch.runtime import client, server
from tests._torch_parity import TINY_CONF, VOCAB, tiny_models

torch.set_num_threads(1)
CHUNK, LEFT = 4, 2
CONF = dict(d_model=32, attention_heads=2, linear_units=64,
            cnn_module_kernel=5, causal=True, static_chunk_size=CHUNK,
            num_left_chunks=LEFT, dropout_rate=0.0)
CHAR_DICT = {f"t{i}": i for i in range(VOCAB)}
SKW = dict(port=0, slots=2, chunk_size=CHUNK, num_left_chunks=LEFT,
           enc_capacity=64, ctc_weight=0.5, reverse_weight=0.3,
           final_mode="attention_rescoring")
BKW = dict(chunk_size=CHUNK, num_left_chunks=LEFT, beam_size=10,
           max_hyp_len=64, enc_capacity=64)
TIMEOUT = 60


@pytest.fixture(scope="module")
def models():
    return tiny_models(5, **CONF)


@pytest.fixture(scope="module")
def servers(models):
    """{"port": the port's AsrServer, "jax": the JAX package's}."""
    jm, variables, _, tm = models
    srvs = {"port": server.AsrServer(tm, CHAR_DICT, **SKW),
            "jax": jax_server.AsrServer(jm, variables, CHAR_DICT, **SKW)}
    for s in srvs.values():
        s.start()
    yield srvs
    for s in srvs.values():
        s.shutdown()


def _wavs(seed, lens):
    # integer-valued, so the client's int16 frames carry them exactly
    rng = np.random.default_rng(seed)
    return [np.round(rng.standard_normal(n) * 3000).astype(np.float32)
            for n in lens]


def _direct(model, wavs, **finish_kw):
    """(tokens, times_ms) of each wav through the port's StreamingBatch
    at S = 1 with the server's float16 windows."""
    batch = StreamingBatch(model, slots=1, transfer_dtype="float16", **BKW)
    out = []
    for w in wavs:
        h = batch.open()
        batch.accept(h, w)
        batch.run_ready()
        out.append((batch.finish(h, **finish_kw), h.result_times_ms()))
        batch.close(h)
    return out


def _session(client_mod, addr, wav, piece=3200, rate=16000,
             wait_partial=False):
    """One client session: the wav in pieces, polling between them, then
    end; with `wait_partial`, it blocks before its last piece until a
    partial arrives (so partials do not depend on thread timing).
    Returns (raw final payload, final event, partial events)."""
    raw = {}

    class Client(client_mod.AsrClient):
        def _note(self, frame):
            ev = super()._note(frame)
            if ev.get("event") == "final":
                raw["final"] = frame[1]
            return ev

    c = Client(*addr, sample_rate=rate, timeout=TIMEOUT)
    try:
        for i in range(0, len(wav), piece):
            if wait_partial and i + piece >= len(wav):
                while not c.partials:
                    frame = server.recv_frame(c.sock)
                    assert frame is not None, "closed before a partial"
                    c._note(frame)
            c.send_audio(wav[i: i + piece])
            c.poll()
        final = c.finish()
        return raw["final"], final, list(c.partials)
    finally:
        c.close()


def _concurrent(client_mod, addr, wavs):
    results = {}

    def run(i):
        results[i] = _session(client_mod, addr, wavs[i], wait_partial=True)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(wavs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert sorted(results) == list(range(len(wavs))), results
    return [results[i] for i in range(len(wavs))]


def test_concurrent_finals_equal_the_jax_server(servers, models):
    """4 clients on 2 slots: the same final bytes from both servers, the
    direct runtime's tokens and times, greedy-prefix partials (each
    client waits for one before its last piece)."""
    tm = models[3]
    wavs = _wavs(1, [16000, 11500, 15000, 7300])
    got = {name: _concurrent(client, s.addr, wavs)
           for name, s in servers.items()}
    direct = _direct(tm, wavs, rescore=True, ctc_weight=0.5,
                     reverse_weight=0.3)
    greedy = _direct(tm, wavs, rescore=False)
    for i, wav in enumerate(wavs):
        raw, final, partials = got["port"][i]
        assert raw == got["jax"][i][0], f"client {i}"
        assert (final["tokens"], final["times_ms"]) == direct[i]
        assert final["text"] == "".join(f"t{t}" for t in direct[i][0])
        assert final["audio_s"] == len(wav) / 16000
        assert final["endpoint"] is False
        streamed = [t for p in partials for t in p["tokens"]]
        assert streamed == greedy[i][0][: len(streamed)]
    assert all(r[2] for r in got["port"]), "a session got no partial"
    assert all(r[1]["tokens"] for r in got["port"])
    assert servers["port"].batch.transfer_dtype == np.float16


def test_wire_both_ways(servers):
    """The port's client on the JAX server and the JAX client on the
    port's server give the same final bytes as each server's own."""
    wav = _wavs(2, [14000])[0]
    mixed = {"port": _session(jax_client, servers["port"].addr, wav, 2000),
             "jax": _session(client, servers["jax"].addr, wav, 2000)}
    assert mixed["port"][0] == mixed["jax"][0]
    assert mixed["port"][0] == _session(client, servers["port"].addr,
                                        wav, 2000)[0]


def test_end_without_audio_and_slot_recycling(servers, models):
    c = client.AsrClient(*servers["port"].addr, timeout=TIMEOUT)
    try:
        final = c.finish()
        assert final["tokens"] == [] and final["text"] == ""
    finally:
        c.close()
    wavs = _wavs(3, [9000] * 5)
    direct = _direct(models[3], wavs, rescore=True, ctc_weight=0.5,
                     reverse_weight=0.3)
    for i, w in enumerate(wavs):
        final = _session(client, servers["port"].addr, w)[1]
        assert (final["tokens"], final["times_ms"]) == direct[i], i


def test_8khz_client(servers):
    """An 8 kHz client: each piece resampled to 16 kHz on arrival, as
    the JAX server does; the same final bytes."""
    wav = _wavs(4, [6000])[0]
    finals = [_session(client, s.addr, wav, 1600, rate=8000)
              for s in (servers["port"], servers["jax"])]
    assert finals[0][0] == finals[1][0]
    assert finals[0][1]["audio_s"] == sum(
        len(resample(wav[i:i + 1600], 8000, 16000))
        for i in range(0, len(wav), 1600)) / 16000
    assert finals[0][1]["tokens"]


def test_endpoint_finalizes_without_end(models):
    """rule 3 at 400 ms: the whole wav arrives, no "end" is sent, and the
    final arrives with endpoint true (all received audio decoded); later
    audio is ignored."""
    tm = models[3]
    wav = _wavs(5, [24000])[0]
    srv = server.AsrServer(tm, CHAR_DICT, endpoint=True,
                           endpoint_config=EndpointConfig(
                               rule3_min_utterance_length=400.0), **SKW)
    srv.start()
    c = client.AsrClient(*srv.addr, timeout=TIMEOUT)
    try:
        c.send_audio(wav)
        while c.final is None:
            frame = server.recv_frame(c.sock)
            assert frame is not None
            c._note(frame)
        assert c.final["endpoint"] is True
        assert c.final["audio_s"] == len(wav) / 16000
        assert (c.final["tokens"], c.final["times_ms"]) == _direct(
            tm, [wav], rescore=True, ctc_weight=0.5, reverse_weight=0.3)[0]
        c.send_audio(wav[:4000])   # ignored: no event, no error
        c.sock.settimeout(0.3)
        with pytest.raises((TimeoutError, socket.timeout)):
            server.recv_frame(c.sock)
    finally:
        c.close()
        srv.shutdown()
    assert not srv._sched.is_alive()


def _error_events(addr, frames) -> list:
    """Send raw frames on a fresh connection; the error events back."""
    sock = socket.create_connection(addr, timeout=TIMEOUT)
    try:
        for kind, payload in frames:
            server.send_frame(sock, kind, payload)
        errors = []
        while len(errors) < len(frames):
            kind, payload = server.recv_frame(sock)
            ev = json.loads(payload)
            if ev["event"] == "error":
                errors.append(ev)
        return sorted(errors, key=json.dumps)
    finally:
        sock.close()


def test_error_events(servers):
    frames = [(server.KIND_JSON, b'{"op": "rewind"}'), (0x43, b"x")]
    got = {name: _error_events(s.addr, frames)
           for name, s in servers.items()}
    assert got["port"] == got["jax"]
    assert [e["message"] for e in got["port"]] == [
        "bad frame kind 67", "unknown op 'rewind'"]


def test_admission_overflow(models):
    """Both slots held; a third session buffering more than
    MAX_PENDING_S (lowered on the instance) gets the overflow error."""
    srv = server.AsrServer(models[3], CHAR_DICT, **SKW)
    srv.MAX_PENDING_S = 0.5
    srv.start()
    holders = [client.AsrClient(*srv.addr, timeout=TIMEOUT)
               for _ in range(2)]
    waiting = None
    try:
        for h in holders:   # both admitted before the third connects
            assert json.loads(server.recv_frame(h.sock)[1])["event"] \
                == "ready"
        waiting = client.AsrClient(*srv.addr, timeout=TIMEOUT)
        waiting.send_audio(np.zeros(16000, np.int16))
        with pytest.raises(RuntimeError, match="admission queue overflow"):
            while True:
                waiting._note(server.recv_frame(waiting.sock))
    finally:
        for c in holders + [waiting]:
            if c is not None:
                c.close()
        srv.shutdown()


def test_serve_flags_are_jax_plus_device():
    def flags(parser):
        return {a.dest: a.default for a in parser._actions
                if a.dest != "help"}

    port, jax = flags(serve.get_parser()), flags(jax_serve.get_parser())
    assert port.pop("device") == "cuda"
    assert port == jax


@pytest.fixture(scope="module")
def serve_setup(tmp_path_factory, models):
    jm, variables, flat, _ = models
    root = tmp_path_factory.mktemp("serve_cli")
    npz = str(root / "model.npz")
    np.savez(npz, **flat)
    jax_ckpt.save_checkpoint(str(root), "jax_ckpt", variables)
    cfg = str(root / "train.json")
    with open(cfg, "w") as f:
        json.dump({"model_conf": dict(TINY_CONF, **CONF),
                   "vocab_size": VOCAB,
                   "collate_conf": {"normalization": True}}, f)
    dict_path = str(root / "dict.txt")
    with open(dict_path, "w") as f:
        f.writelines(f"{t} {i}\n" for t, i in CHAR_DICT.items())
    return dict(npz=npz, jax_ckpt=str(root / "jax_ckpt"), cfg=cfg,
                dict=dict_path)


def _serve_args(s, ckpt, *extra):
    return ["--config", s["cfg"], "--checkpoint", ckpt, "--dict", s["dict"],
            "--port", "0", "--slots", "2", "--chunk_size", str(CHUNK),
            "--num_left_chunks", str(LEFT), "--enc_capacity", "64",
            "--reverse_weight", "0.3", *extra]


def test_serve_cuda_without_a_card_raises(serve_setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.build_server(serve.get_parser().parse_args(
            _serve_args(serve_setup, serve_setup["npz"])))


def test_serve_int8_equals_the_jax_serve(serve_setup):
    """bin/serve --quantize int8 --device cpu and the JAX serve with
    --quantize int8 ("running" normalisation, per the config): the same
    final bytes."""
    s = serve_setup
    srvs = [serve.build_server(serve.get_parser().parse_args(
                _serve_args(s, s["npz"], "--quantize", "int8", "--device",
                            "cpu"))),
            jax_serve.build_server(jax_serve.get_parser().parse_args(
                _serve_args(s, s["jax_ckpt"], "--quantize", "int8")))]
    assert srvs[0].batch.normalization == "running"
    assert srvs[0].batch.model.encoder.embed.Dense_0.q is not None
    wav = _wavs(6, [15000])[0]
    try:
        for srv in srvs:
            srv.start()
        finals = [_session(client, srv.addr, wav) for srv in srvs]
    finally:
        for srv in srvs:
            srv.shutdown()
    assert finals[0][0] == finals[1][0]
    assert finals[0][1]["tokens"]


def test_transfer_dtype(models):
    """float32 (the default) hands the step the windows as built;
    float16 hands it their float16 rounding, and its finals and times
    equal JAX's StreamingBatch(transfer_dtype="float16")."""
    jm, variables, _, tm = models
    wavs = _wavs(7, [14200, 9800])
    seen = {}
    got = {}
    for name, b in (
            ("f32", StreamingBatch(tm, slots=2, **BKW)),
            ("f16", StreamingBatch(tm, slots=2, transfer_dtype="float16",
                                   **BKW)),
            ("jax", jax_streaming_batch.StreamingBatch(
                jm, variables, slots=2, transfer_dtype="float16", **BKW))):
        if name != "jax":
            step = b._step

            def spy(windows, valid, active, step=step, name=name):
                seen.setdefault(name, []).append(windows.copy())
                return step(windows, valid, active)
            b._step = spy
        hs = [b.open() for _ in wavs]
        for h, w in zip(hs, wavs):
            b.accept(h, w)
        b.run_ready()
        finals = b.finish_many(hs, rescore=True, ctc_weight=0.5,
                               reverse_weight=0.3)
        got[name] = [(finals[h.slot], h.result_times_ms()) for h in hs]
    assert all(w.dtype == np.float32 for w in seen["f32"])
    assert all(w.dtype == np.float16 for w in seen["f16"])
    assert len(seen["f16"]) == len(seen["f32"])
    for w32, w16 in zip(seen["f32"], seen["f16"]):
        np.testing.assert_array_equal(w32.astype(np.float16), w16)
    assert any((w32 != w16.astype(np.float32)).any()
               for w32, w16 in zip(seen["f32"], seen["f16"]))
    assert got["f16"] == got["jax"]
    assert all(toks for toks, _ in got["f16"])
