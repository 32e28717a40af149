"""Batched online recognition: S streams advanced by one chunk step
(PyTorch). Port of openeat_tpu/decode/streaming_batch.py.

The device holds the state of S slots:
- per encoder block, K and V histories [S, left, H, Dk] and a conv
  cache [S, K-1, D];
- offsets and cache lengths [S], so each slot has its own absolute
  position: the chunk step takes a position table [S, left + c, D] and
  a kv mask [S, 1, left + c] built from the per-slot values (the JAX
  package reaches the same through jax.vmap of its S = 1 body);
- a carried CTC prefix-beam state ([S, K, ...]), advanced frame by
  frame inside the step;
- an encoder-output ring [S, cap + c, D] for the end-of-stream
  rescoring.

One step advances every slot that has a full feature window (or a
forced, short final chunk). The other slots run too, on zero windows,
and keep their state: every field is selected with torch.where. Within
a final chunk, frames past its valid length are identity steps of the
beam search. `finish` / `finish_many` flush the tail as the S = 1
runtime does, then finalize: the prefix-beam n-best rescored by the
forward and reverse decoders over the ring (rescoring_scores), or the
greedy result. Slots are reset and reused; `StreamHandle` is the S = 1
API over one slot.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from openeat_torch.decode.ctc_prefix_beam import (prefix_beam_finalize,
                                                  prefix_beam_init,
                                                  prefix_beam_step)
from openeat_torch.decode.endpoint import EndpointConfig, Endpointer
from openeat_torch.decode.rescoring import rescoring_scores
from openeat_torch.decode.streaming import (FRAME_MS, HostFrontend,
                                            check_streamable, zero_caches)
from openeat_torch.models.asr_model import ASRModel


class _Slot:
    """The host's part of one stream."""

    def __init__(self, mel: int, rate: int, normalization: str,
                 endpoint_config: EndpointConfig | None, blank_id: int):
        self.in_use = False
        self.fe = HostFrontend(mel, rate, normalization)
        self.hyp: list[int] = []
        self.times: list[int] = []  # emission position of each token
        self.prev_tok = -1
        self.finished = False
        self.endpointer = Endpointer(endpoint_config, frame_ms=FRAME_MS,
                                     blank_id=blank_id)


class StreamHandle:
    """The single-stream API over one slot of a StreamingBatch. Unlike
    StreamingRecognizer.finish, `finish()` returns the whole final
    result (rescoring replaces the greedy partial)."""

    def __init__(self, batch: "StreamingBatch", slot: int):
        self._batch = batch
        self.slot = slot

    def accept_waveform(self, wav) -> list[int]:
        self._batch.accept(self, wav)
        return self._batch.run_ready().get(self.slot, [])

    def finish(self, **kw) -> list[int]:
        return self._batch.finish(self, **kw)

    def result(self) -> list[int]:
        return list(self._batch._slots[self.slot].hyp)

    def result_times_ms(self) -> list[float]:
        """Emission time (onset, ms) of each token of result(): of the
        greedy path before finish(), of the winning prefix-beam
        hypothesis after a rescoring finish()."""
        return [p * FRAME_MS for p in self._batch._slots[self.slot].times]

    def endpoint_detected(self) -> bool:
        return self._batch._slots[self.slot].endpointer.detected


class StreamingBatch:
    """S-slot batched streaming recognizer (see the module text)."""

    def __init__(self, model: ASRModel, *, slots: int = 8,
                 chunk_size: int = 16, num_left_chunks: int = 4,
                 sample_rate: int = 16000, num_mel_bins: int | None = None,
                 blank_id: int = 0, normalization: str = "none",
                 beam_size: int = 10, max_hyp_len: int = 64,
                 enc_capacity: int = 512,
                 endpoint_config: EndpointConfig | None = None,
                 transfer_dtype: str = "float32"):
        check_streamable(model, num_left_chunks)
        self.model = model
        self.device = dev = next(model.parameters()).device
        self.S = s = slots
        self.chunk = chunk_size
        self.left = num_left_chunks * chunk_size
        self.rate = sample_rate
        self.mel = num_mel_bins or model.input_size
        self.blank_id = blank_id
        self.normalization = normalization
        self.beam_size = beam_size
        self.max_hyp_len = max_hyp_len
        self.cap = enc_capacity
        self.win_frames = 4 * chunk_size + 3
        self.endpoint_config = endpoint_config
        # the feature windows' dtype on the way to the device: the server
        # passes float16, which rounds each window as the JAX package's
        # packed float16 upload does and halves the copy; the step widens
        # it to float32 on the device
        self.transfer_dtype = np.dtype(transfer_dtype)
        self.k, self.v, self.cnn = zero_caches(model, s, self.left, dev)
        self.cache_len = torch.zeros((s,), dtype=torch.long, device=dev)
        self.offset = torch.zeros((s,), dtype=torch.long, device=dev)
        self.beam = prefix_beam_init(s, beam_size, max_hyp_len, dev, True)
        self.enc_buf = torch.zeros((s, self.cap + chunk_size, model.d_model),
                                   device=dev)
        self._slots = [self._new_slot() for _ in range(s)]
        self._dirty: set[int] = set()
        # host copy of `offset`: it grows by `chunk` per active step, so
        # scheduling never reads the device
        self._offset_host = np.zeros((s,), np.int64)

    def _new_slot(self) -> _Slot:
        return _Slot(self.mel, self.rate, self.normalization,
                     self.endpoint_config, self.blank_id)

    # ---- slot lifecycle

    def open(self) -> StreamHandle:
        for i, sl in enumerate(self._slots):
            if not sl.in_use:
                self._slots[i] = self._new_slot()
                self._slots[i].in_use = True
                # a slot whose device state ever moved is zeroed before
                # the next step (all pending resets in one pass)
                if self._offset_host[i]:
                    self._dirty.add(i)
                    self._offset_host[i] = 0
                return StreamHandle(self, i)
        raise RuntimeError(f"all {self.S} stream slots are in use")

    def close(self, handle: StreamHandle) -> None:
        self._slots[handle.slot].in_use = False

    @torch.inference_mode()
    def _flush_resets(self) -> None:
        if not self._dirty:
            return
        mask = torch.zeros((self.S,), dtype=torch.bool)
        mask[list(self._dirty)] = True
        mask = mask.to(self.device)
        self._dirty.clear()

        def zero(t):
            m = mask.view((-1,) + (1,) * (t.dim() - 1))
            return torch.where(m, torch.zeros((), dtype=t.dtype,
                                              device=t.device), t)

        self.k = [zero(t) for t in self.k]
        self.v = [zero(t) for t in self.v]
        self.cnn = [zero(t) for t in self.cnn]
        self.cache_len, self.offset = zero(self.cache_len), zero(self.offset)
        self.enc_buf = zero(self.enc_buf)
        self.beam.keep_where(~mask, prefix_beam_init(
            self.S, self.beam_size, self.max_hyp_len, self.device, True))

    # ---- audio in

    def accept(self, handle: StreamHandle, wav) -> None:
        sl = self._slots[handle.slot]
        if sl.finished:
            raise RuntimeError("accept() after finish(); streams are "
                               "one-shot")
        sl.fe.accept(wav)

    def _ready(self, i: int) -> bool:
        sl = self._slots[i]
        return (sl.in_use and not sl.finished and sl.fe.n_frames
                - 4 * int(self._offset_host[i]) >= self.win_frames)

    # ---- the batched chunk step

    @torch.inference_mode()
    def _step(self, windows: np.ndarray, valid: np.ndarray,
              active: np.ndarray) -> torch.Tensor:
        """Advance the active slots by one chunk; returns the greedy
        frame tokens [S, c] (on the device)."""
        dev, c = self.device, self.chunk
        win = torch.from_numpy(windows).to(dev).float()
        scal = torch.from_numpy(np.stack([valid, active.astype(np.int64)])
                                ).to(dev)
        valid_d, act = scal[0], scal[1].bool()
        enc, k_new, v_new, cnn_new = self.model.encode_chunk(
            win, self.offset, self.k, self.v, self.cache_len, self.cnn,
            valid_d)
        logp = self.model.ctc_log_probs(enc).float()     # [S, c, V]
        toks = logp.argmax(-1)

        def sel(new, old):
            return torch.where(act.view((-1,) + (1,) * (new.dim() - 1)),
                               new, old)

        if self.left > 0:
            self.k = [sel(torch.cat([kc, kn], 1)[:, -self.left:], kc)
                      for kc, kn in zip(self.k, k_new)]
            self.v = [sel(torch.cat([vc, vn], 1)[:, -self.left:], vc)
                      for vc, vn in zip(self.v, v_new)]
        self.cnn = [sel(cn, co) for cn, co in zip(cnn_new, self.cnn)]
        old_beam = copy.copy(self.beam)
        for i in range(c):
            prefix_beam_step(self.beam, logp[:, i], valid_d > i,
                             self.blank_id, self.offset + i)
        self.beam.keep_where(act, old_beam)
        # the ring: rows [offset, offset + c); a stream past `cap` keeps
        # decoding, its rows land in the tail (rescoring reads <= cap)
        rows = (torch.clamp(self.offset, max=self.cap)[:, None]
                + torch.arange(c, device=dev))[..., None].expand(
            -1, -1, self.enc_buf.shape[2])
        self.enc_buf.scatter_(1, rows, sel(enc, self.enc_buf.gather(1, rows)))
        self.cache_len = sel(torch.clamp(self.cache_len + c, max=self.left),
                             self.cache_len)
        self.offset = sel(self.offset + c, self.offset)
        return toks

    def run_ready(self, force: dict[int, int] | None = None
                  ) -> dict[int, list[int]]:
        """Advance every slot with a full feature window by one chunk,
        again until none is ready; `force` maps slot -> valid length of
        a final chunk allowed to run short (each entry used once).
        Returns {slot: newly emitted greedy tokens}. The steps are
        queued without a device sync; their tokens are read back once,
        at the end."""
        force = dict(force or {})
        self._flush_resets()
        pending = []
        while True:
            valid = np.zeros((self.S,), np.int64)
            active = np.zeros((self.S,), bool)
            windows = np.zeros((self.S, self.win_frames, self.mel),
                               self.transfer_dtype)
            for i in range(self.S):
                run_full = self._ready(i)
                if not (run_full or i in force):
                    continue
                forced = force.pop(i, None)
                w = self._slots[i].fe.window(4 * int(self._offset_host[i]),
                                             self.win_frames)
                windows[i, : w.shape[0]] = w
                valid[i] = self.chunk if run_full else forced
                active[i] = True
            if not active.any():
                break
            pos0 = self._offset_host.copy()
            toks = self._step(windows, valid, active)
            self._offset_host[active] += self.chunk
            pending.append((active, valid, pos0, toks))
        emitted: dict[int, list[int]] = {}
        if not pending:
            return emitted
        all_toks = torch.stack([p[3] for p in pending]).cpu().numpy()
        for (act, valid, pos0, _), toks in zip(pending, all_toks):
            for i in np.flatnonzero(act):
                sl = self._slots[i]
                frame_toks = toks[i, : valid[i]].tolist()
                out = []
                for j, t in enumerate(frame_toks):
                    if t != sl.prev_tok and t != self.blank_id:
                        out.append(t)
                        sl.times.append(int(pos0[i]) + j)
                    sl.prev_tok = t
                sl.endpointer.feed(frame_toks)
                sl.hyp += out
                emitted.setdefault(int(i), []).extend(out)
        return emitted

    # ---- end of stream

    def finish(self, handle: StreamHandle, *, rescore: bool = True,
               ctc_weight: float = 0.5, reverse_weight: float = 0.0
               ) -> list[int]:
        """Flush the tail and finalize one stream: the prefix-beam +
        attention-rescoring result (rescore=True) or the greedy one.
        Other ready streams ride along in the same steps."""
        return self.finish_many([handle], rescore=rescore,
                                ctc_weight=ctc_weight,
                                reverse_weight=reverse_weight)[handle.slot]

    def finish_many(self, handles: list, *, rescore: bool = True,
                    ctc_weight: float = 0.5, reverse_weight: float = 0.0
                    ) -> dict[int, list[int]]:
        """Finish several streams: their tail chunks advance in the same
        steps and their finals are rescored in one decoder pass.
        Returns {slot: final result}."""
        out: dict[int, list[int]] = {}
        todo: list[int] = []
        for h in handles:
            sl = self._slots[h.slot]
            if sl.finished:
                out[h.slot] = list(sl.hyp)
                continue
            sl.finished = True
            sl.fe.flush_tail()
            todo.append(h.slot)
        if not todo:
            return out
        t_tot = {i: self._slots[i].fe.t_total() for i in todo}
        # more than a chunk left means 4c + 3 real frames remain, so
        # these forced chunks are full; only each stream's last is short
        while True:
            force = {i: self.chunk for i in todo
                     if t_tot[i] - int(self._offset_host[i]) > self.chunk}
            if not force:
                break
            self.run_ready(force=force)
        short = {i: t_tot[i] - int(self._offset_host[i]) for i in todo}
        short = {i: r for i, r in short.items() if r > 0}
        if short:
            self.run_ready(force=short)
        # a stream with no encoder rows keeps its (empty) greedy result:
        # rescoring over an all-masked memory would give NaN scores
        rs = [i for i in todo if rescore and t_tot[i] > 0]
        for i in todo:
            if i not in rs:
                out[i] = list(self._slots[i].hyp)
        if rs:
            best, blens, btimes = self._finalize(rs, [min(t_tot[i], self.cap)
                                                      for i in rs],
                                                 ctc_weight, reverse_weight)
            for j, i in enumerate(rs):
                sl = self._slots[i]
                n = int(blens[j])
                sl.hyp = [int(t) for t in best[j, :n]]
                sl.times = [int(t) for t in btimes[j, :n]]
                out[i] = list(sl.hyp)
        return out

    @torch.inference_mode()
    def _finalize(self, slots: list[int], enc_lens: list[int],
                  ctc_weight: float, reverse_weight: float):
        """The slots' beams sorted, every candidate rescored in one
        batched decoder pass, the winners picked: host (tokens [F, L],
        lens [F], times [F, L])."""
        idx = torch.tensor(slots, device=self.device)
        nb, nl, ns, nt = prefix_beam_finalize(self.beam.rows(idx), True)
        score = rescoring_scores(
            self.model, self.enc_buf[idx, :self.cap],
            torch.tensor(enc_lens, device=self.device), nb, nl, ns,
            ctc_weight=ctc_weight, reverse_weight=reverse_weight)
        win = score.argmax(-1)
        rows = torch.arange(len(slots), device=self.device)
        return (nb[rows, win].cpu().numpy(), nl[rows, win].cpu().numpy(),
                nt[rows, win].cpu().numpy())

    def encoder_out(self, handle: StreamHandle) -> np.ndarray:
        """The stream's valid encoder rows so far (offset moves a whole
        chunk even on a short final chunk, so clamp to the frontend's
        real length)."""
        i = handle.slot
        n = min(int(self._offset_host[i]), self.cap,
                max(self._slots[i].fe.t_total(), 0))
        return self.enc_buf[i, :n].cpu().numpy()
