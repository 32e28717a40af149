"""Client of the streaming ASR server (runtime/server.py; PyTorch port of
openeat_tpu/runtime/client.py, the same API and frames, so either
client talks to either server):

    c = AsrClient(host, port)
    c.send_audio(pcm_int16_or_float)     # any piece size, repeatedly
    c.poll()                             # partials as they stream in
    final = c.finish()                   # sends end, waits for the final
    c.close()
"""

from __future__ import annotations

import json
import socket

import numpy as np

from openeat_torch.runtime.server import (KIND_JSON, KIND_PCM, recv_frame,
                                          send_frame, send_json)


class AsrClient:
    def __init__(self, host: str, port: int, sample_rate: int = 16000,
                 timeout: float = 120.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        send_json(self.sock, {"op": "open", "sample_rate": sample_rate})
        self.partials: list[dict] = []
        self.final: dict | None = None

    def send_audio(self, wav) -> None:
        """wav: int16 samples, or floats in the +-32768 kaldi range
        (rounded and clipped to int16)."""
        wav = np.asarray(wav)
        if wav.dtype != np.int16:
            wav = np.clip(np.round(wav), -32768, 32767).astype(np.int16)
        send_frame(self.sock, KIND_PCM, wav.astype("<i2").tobytes())

    def poll(self, max_events: int = 100) -> list[dict]:
        """Drain the events that have arrived (a short socket timeout);
        partials collect in self.partials."""
        out = []
        old = self.sock.gettimeout()
        self.sock.settimeout(0.01)
        try:
            for _ in range(max_events):
                try:
                    frame = recv_frame(self.sock)
                except (TimeoutError, socket.timeout):
                    break
                if frame is None:
                    break
                out.append(self._note(frame))
        finally:
            self.sock.settimeout(old)
        return out

    def finish(self) -> dict:
        """Send end-of-stream; block until the final event arrives."""
        send_json(self.sock, {"op": "end"})
        while self.final is None:
            frame = recv_frame(self.sock)
            if frame is None:
                raise ConnectionError("server closed before the final event")
            self._note(frame)
        return self.final

    def _note(self, frame) -> dict:
        kind, payload = frame
        if kind != KIND_JSON:
            raise ValueError(f"server sent frame kind {kind}")
        ev = json.loads(payload.decode("utf-8"))
        if ev.get("event") == "partial":
            self.partials.append(ev)
        elif ev.get("event") == "final":
            self.final = ev
        elif ev.get("event") == "error":
            raise RuntimeError(f"server error: {ev.get('message')}")
        return ev

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
