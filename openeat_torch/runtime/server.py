"""Streaming ASR serving runtime: a TCP server over StreamingBatch
(PyTorch). Port of openeat_tpu/runtime/server.py.

One scheduler thread owns the device state: it advances up to S client
streams per chunk step of the batched runtime (decode/streaming_batch.py)
and drains every message that arrived into the next step (continuous
batching; a new session takes a free slot the moment one opens). The
per-connection reader and writer threads touch only host queues.

Wire protocol (framed, binary-safe), byte for byte the JAX server's:

    frame := kind:uint8  length:uint32_be  payload[length]
    kind 0x4A ('J') - UTF-8 JSON control/event object
    kind 0x42 ('B') - raw little-endian int16 PCM audio samples

Client -> server:
    J {"op": "open", "sample_rate": 16000}   (optional; implicit on
                                              the first audio frame)
    B <pcm bytes>                            (any piece size)
    J {"op": "end"}                          -> final hypothesis
Server -> client:
    J {"event": "ready", "slot": i}
    J {"event": "partial", "tokens": [...], "text": "...",
       "times_ms": [...]}
    J {"event": "final", "tokens": [...], "text": "...",
       "times_ms": [...], "audio_s": 1.23, "endpoint": false}
    J {"event": "error", "message": "..."}

Partials are the CTC greedy path, sent when a chunk step emits tokens;
the final is the prefix-beam n-best rescored by the forward and reverse
decoders (or the greedy result, final_mode="ctc_greedy_search").
`times_ms` are CTC emission onsets (40 ms a position). With
`endpoint=True` the server finalizes a stream itself when the
trailing-silence rules fire (decode/endpoint.py): the final then has
"endpoint": true and later audio on the connection is ignored. Sessions
beyond S wait in a FIFO admission queue, each holding at most
MAX_PENDING_S seconds of audio. The feature windows cross to the device
in float16, as the JAX server's do.
"""

from __future__ import annotations

import json
import logging
import queue
import socket
import socketserver
import struct
import threading

import numpy as np
import torch

from openeat_torch.dataset.audio import resample
from openeat_torch.dataset.text import token_ids_to_text
from openeat_torch.decode.streaming_batch import StreamingBatch

KIND_JSON = 0x4A
KIND_PCM = 0x42
_HDR = struct.Struct(">BI")
MAX_FRAME = 1 << 24  # 16 MiB; a frame larger than this is a bad client
POLL_S = 0.05        # the scheduler's wait for a message before a step


# ---------------------------------------------------------------- frames

def send_frame(sock: socket.socket, kind: int, payload: bytes) -> None:
    sock.sendall(_HDR.pack(kind, len(payload)) + payload)


def send_json(sock: socket.socket, obj: dict) -> None:
    send_frame(sock, KIND_JSON, json.dumps(obj).encode("utf-8"))


def recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket) -> tuple[int, bytes] | None:
    hdr = recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    kind, length = _HDR.unpack(hdr)
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    payload = recv_exact(sock, length) if length else b""
    if payload is None:
        return None
    return kind, payload


# ---------------------------------------------------------------- server

class _Session:
    """Host-side state of one client connection."""

    _ids = iter(range(1, 1 << 62))

    def __init__(self, conn: socket.socket):
        self.id = next(self._ids)
        self.conn = conn
        self.outbox: queue.Queue = queue.Queue()
        self.handle = None          # StreamHandle once admitted
        self.sample_rate = 16000
        self.ended = False          # the client sent "end"
        self.closed = False         # the connection is torn down
        self.audio_samples = 0
        self.sent_n = 0             # greedy tokens already sent as partials
        self.pending_audio: list = []   # audio queued before admission


class AsrServer:
    """Continuous-batching streaming ASR server (see the module text).

    `model` as bin.recognize.load_model returns it, on its device;
    `char_dict` maps token -> id. The decode settings are
    bin/stream_recognize's."""

    MAX_PENDING_S = 600.0  # audio a session may buffer before admission

    def __init__(self, model, char_dict, *, host="127.0.0.1", port=0,
                 slots=8, chunk_size=16, num_left_chunks=4,
                 sample_rate=16000, normalization="none", beam_size=10,
                 max_hyp_len=64, enc_capacity=512, ctc_weight=0.5,
                 reverse_weight=0.0, final_mode="attention_rescoring",
                 endpoint=False, endpoint_config=None):
        self.batch = StreamingBatch(
            model, slots=slots, chunk_size=chunk_size,
            num_left_chunks=num_left_chunks, sample_rate=sample_rate,
            normalization=normalization, beam_size=beam_size,
            max_hyp_len=max_hyp_len, enc_capacity=enc_capacity,
            endpoint_config=endpoint_config, transfer_dtype="float16")
        self.endpoint = endpoint
        self.id2tok = {v: k for k, v in char_dict.items()}
        self.server_rate = sample_rate
        self.ctc_weight = ctc_weight
        self.reverse_weight = reverse_weight
        self.rescore = final_mode == "attention_rescoring"
        self.inbox: queue.Queue = queue.Queue()
        self._admit: list[_Session] = []   # waiting for a slot (FIFO)
        self._live: dict[int, _Session] = {}   # session id -> session
        self._stop = threading.Event()
        self._sched = threading.Thread(target=self._scheduler_loop,
                                       name="asr-scheduler", daemon=True)

        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):  # runs in a per-connection thread
                outer._handle_conn(self.request)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._tcp = Server((host, port), Handler)
        self.addr = self._tcp.server_address

    # ---- lifecycle

    def start(self) -> tuple[str, int]:
        self._sched.start()
        threading.Thread(target=self._tcp.serve_forever,
                         name="asr-accept", daemon=True).start()
        return self.addr

    def shutdown(self) -> None:
        self._stop.set()
        self._tcp.shutdown()
        self._tcp.server_close()
        self._sched.join(timeout=10)

    def serve_forever(self) -> None:
        self._sched.start()
        try:
            self._tcp.serve_forever()
        finally:
            self._stop.set()

    # ---- connection threads

    def _handle_conn(self, conn: socket.socket) -> None:
        sess = _Session(conn)
        writer = threading.Thread(target=self._writer_loop, args=(sess,),
                                  daemon=True)
        writer.start()
        self.inbox.put(("open", sess, None))
        try:
            while True:
                frame = recv_frame(conn)
                if frame is None:
                    break
                kind, payload = frame
                if kind == KIND_PCM:
                    pcm = np.frombuffer(payload, dtype="<i2")
                    self.inbox.put(("audio", sess, pcm))
                elif kind == KIND_JSON:
                    msg = json.loads(payload.decode("utf-8"))
                    op = msg.get("op")
                    if op == "open":
                        sess.sample_rate = int(
                            msg.get("sample_rate", self.server_rate))
                    elif op == "end":
                        # one utterance per connection: the writer sends
                        # the final, then the client closes; read on
                        # until EOF
                        self.inbox.put(("end", sess, None))
                    else:
                        sess.outbox.put({"event": "error",
                                         "message": f"unknown op {op!r}"})
                else:
                    sess.outbox.put({"event": "error",
                                     "message": f"bad frame kind {kind}"})
        except (ConnectionError, ValueError, json.JSONDecodeError, OSError):
            pass
        finally:
            self.inbox.put(("close", sess, None))
            sess.outbox.put(None)  # stops the writer

    def _writer_loop(self, sess: _Session) -> None:
        try:
            while True:
                item = sess.outbox.get()
                if item is None:
                    break
                send_json(sess.conn, item)
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                sess.conn.shutdown(socket.SHUT_WR)
            except OSError:
                pass

    # ---- the scheduler thread: the only one touching device state

    def _scheduler_loop(self) -> None:
        # grad mode is per thread: this thread enters inference mode
        # itself (StreamingBatch puts every tensor on the model's device)
        with torch.inference_mode():
            while not self._stop.is_set():
                self._serve_once()

    def _serve_once(self) -> None:
        try:
            msg = self.inbox.get(timeout=POLL_S)
        except queue.Empty:
            self._advance()
            return
        batchable = [msg]
        # drain whatever else arrived, so that one step serves every
        # session with fresh audio (continuous batching)
        while True:
            try:
                batchable.append(self.inbox.get_nowait())
            except queue.Empty:
                break
        for kind, sess, data in batchable:
            try:
                self._apply(kind, sess, data)
            except Exception as e:  # keep serving the other sessions
                sess.outbox.put({"event": "error", "message": str(e)})
                self._teardown(sess)
        try:
            self._advance()
        except Exception:
            # a failed chunk step fails every live session (their state
            # is shared) but not the scheduler: it goes on serving
            logging.getLogger(__name__).exception(
                "chunk step failed; dropping live sessions")
            for sess in list(self._live.values()):
                sess.outbox.put({"event": "error",
                                 "message": "internal decode error"})
                self._teardown(sess)

    def _apply(self, kind: str, sess: _Session, data) -> None:
        if kind == "open":
            self._try_admit(sess)
        elif kind == "audio":
            if sess.closed or sess.ended:
                return
            wav = data.astype(np.float32)
            if sess.sample_rate != self.server_rate:
                wav = resample(wav, sess.sample_rate, self.server_rate)
            sess.audio_samples += len(wav)
            if sess.handle is None:
                # a session may buffer at most MAX_PENDING_S seconds of
                # audio before a slot frees; past that the client (or
                # the load) is out of bounds, and buffering on would
                # grow host memory without limit
                pend = sum(len(a) for a in sess.pending_audio)
                if pend + len(wav) > self.MAX_PENDING_S * self.server_rate:
                    raise RuntimeError(
                        f"admission queue overflow: >{self.MAX_PENDING_S}"
                        " s of audio buffered before a slot freed")
                sess.pending_audio.append(wav)
            else:
                self.batch.accept(sess.handle, wav)
        elif kind == "end":
            if sess.closed or sess.ended:
                return
            sess.ended = True
            if sess.handle is None and not sess.pending_audio:
                # ended before any audio: an empty final
                sess.outbox.put({"event": "final", "tokens": [],
                                 "text": "", "audio_s": 0.0})
                self._teardown(sess)
                return
            if sess.handle is not None:
                self._finalize(sess)
            # else: finalized on admission (queued audio, then end)
        elif kind == "close":
            self._teardown(sess)

    def _try_admit(self, sess: _Session) -> None:
        if sess.closed:
            return
        try:
            sess.handle = self.batch.open()
        except RuntimeError:
            self._admit.append(sess)
            return
        self._live[sess.id] = sess
        sess.outbox.put({"event": "ready", "slot": sess.handle.slot})
        for wav in sess.pending_audio:
            self.batch.accept(sess.handle, wav)
        sess.pending_audio = []
        if sess.ended:
            self._finalize(sess)

    def _finalize(self, sess: _Session, *, endpoint: bool = False) -> None:
        toks = self.batch.finish(sess.handle, rescore=self.rescore,
                                 ctc_weight=self.ctc_weight,
                                 reverse_weight=self.reverse_weight)
        sess.outbox.put({
            "event": "final", "tokens": [int(t) for t in toks],
            "text": token_ids_to_text(toks, self.id2tok),
            "times_ms": sess.handle.result_times_ms(),
            "audio_s": sess.audio_samples / self.server_rate,
            "endpoint": endpoint})
        self._release(sess)

    def _release(self, sess: _Session) -> None:
        if sess.handle is not None:
            self.batch.close(sess.handle)
            sess.handle = None
            self._live.pop(sess.id, None)
            while self._admit:
                waiter = self._admit.pop(0)
                if not waiter.closed:
                    self._try_admit(waiter)
                    break

    def _teardown(self, sess: _Session) -> None:
        sess.closed = True
        if sess in self._admit:
            self._admit.remove(sess)
        self._release(sess)

    def _advance(self) -> None:
        """One round of chunk steps over every slot with a ready window,
        then the greedy partials. Partials come from each handle's
        accumulated result(), not from run_ready()'s return, so tokens
        emitted in steps that rode along inside another session's
        finish() are not lost."""
        self.batch.run_ready()
        self._emit_partials()
        if self.endpoint:
            self._check_endpoints()

    def _emit_partials(self) -> None:
        for sess in list(self._live.values()):
            if sess.handle is None or sess.ended:
                continue
            hyp = sess.handle.result()
            if len(hyp) > sess.sent_n:
                toks = hyp[sess.sent_n:]
                times = sess.handle.result_times_ms()[sess.sent_n:]
                sess.sent_n = len(hyp)
                sess.outbox.put({
                    "event": "partial", "tokens": [int(t) for t in toks],
                    "text": token_ids_to_text(toks, self.id2tok),
                    "times_ms": times})

    def _check_endpoints(self) -> None:
        """Server-side finalization: a session whose greedy path meets
        the trailing-silence rules gets its final without the client's
        "end" (and "endpoint": true)."""
        for sess in list(self._live.values()):
            if (sess.handle is not None and not sess.ended
                    and sess.handle.endpoint_detected()):
                sess.ended = True  # later audio frames are ignored
                self._finalize(sess, endpoint=True)
