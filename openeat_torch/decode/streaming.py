"""Online (streaming) recognition of one stream: chunked encoder and
incremental CTC (PyTorch). Port of openeat_tpu/decode/streaming.py.

- Audio arrives in pieces of any size (`accept_waveform`). The fbank
  frames are computed on the host CPU, in groups of 16 frames (larger
  power-of-2 groups for a backlog), with the port's own
  openeat_torch/ops/fbank.py: each frame reads only its own 400 samples,
  so grouping is exact. The JAX package runs this half on the host too;
  it is small work in many tiny calls, which the card would only add
  launch and copy latency to.
- The encoder runs chunk by chunk on the model's device through
  ASRModel.encode_chunk, with right-aligned attention K/V histories of
  num_left_chunks * chunk_size positions and per-layer conv caches: the
  offline forward of a model with causal convs and
  `static_chunk_size` / `num_left_chunks` masks, one chunk at a time.
- The CTC greedy partial result and its emission times update after
  every chunk, and the endpointer reads the same greedy path.
- `finish()` flushes the tail: the last sub-group fbank frames and a
  last, zero-padded chunk whose padding attention does not read
  (encode_chunk's valid_len); its outputs past the valid ones are
  dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from openeat_torch.decode.endpoint import EndpointConfig, Endpointer
from openeat_torch.models.asr_model import ASRModel
from openeat_torch.ops import fbank as fbank_mod

# ms of audio per encoder position: 10 ms frames through conv2d x4
FRAME_MS = 40.0


def _fbank_group(seg: np.ndarray, rate: int, mel: int) -> np.ndarray:
    """fbank frames [n, mel] of one group's samples, on the host CPU."""
    with torch.no_grad():
        feats, _ = fbank_mod.fbank(
            torch.from_numpy(np.ascontiguousarray(seg, np.float32))[None],
            torch.tensor([len(seg)]), sample_rate=rate, num_mel_bins=mel)
    return feats[0].numpy()


class HostFrontend:
    """The host's feature pipeline of ONE stream: sample buffer,
    group-wise fbank, the end-of-stream tail flush and the causal
    "running" normalisation. The single-stream runtime and every slot of
    StreamingBatch share it.

    "running" applies the training frontend's per-utterance mean and
    variance formula with statistics over the frames a window may see,
    [0, f0 + n): the streamable stand-in for per-utterance
    normalisation, and independent of how the audio arrived. Samples
    already folded into frames and frames behind the consumer's window
    are trimmed (both buffers keep an absolute base index), so a long
    stream holds bounded host memory."""

    FRAME_GROUP = 16
    # the largest group a backlog is extracted in (powers of 2 from 16)
    MAX_GROUP_FRAMES = 512

    def __init__(self, mel: int, rate: int, normalization: str = "none"):
        if normalization not in ("none", "running"):
            raise ValueError(f"normalization {normalization!r}")
        self.mel = mel
        self.rate = rate
        self.normalization = normalization
        self.frame_len = int(rate * 0.025)
        self.frame_shift = int(rate * 0.010)
        self.group_samples = ((self.FRAME_GROUP - 1) * self.frame_shift
                              + self.frame_len)
        self.samples = np.zeros((0,), np.float32)
        self._samples_base = 0   # absolute index of samples[0]
        self.frames = np.zeros((0, mel), np.float32)
        self._frames_base = 0    # absolute index of frames[0]
        self.n_frames_done = 0
        self._nsum = np.zeros((mel,), np.float64)
        self._nsumsq = np.zeros((mel,), np.float64)
        self._nn = 0

    @property
    def n_samples(self) -> int:
        """Absolute count of samples accepted so far."""
        return self._samples_base + len(self.samples)

    @property
    def n_frames(self) -> int:
        """Absolute count of fbank frames extracted so far."""
        return self._frames_base + self.frames.shape[0]

    def accept(self, wav) -> None:
        self.samples = np.concatenate([self.samples,
                                       np.asarray(wav, np.float32)])
        self._extract_full_groups()

    def _ingest(self, feats: np.ndarray) -> None:
        self.frames = np.concatenate([self.frames, feats], axis=0)

    def _trim_samples(self) -> None:
        # samples before the next group's start are never read again
        cut = self.n_frames_done * self.frame_shift - self._samples_base
        if cut > 0:
            self.samples = self.samples[cut:]
            self._samples_base += cut

    def _extract_full_groups(self) -> None:
        n_avail = fbank_mod.num_frames(self.n_samples, self.frame_len,
                                       self.frame_shift)
        while True:
            todo = n_avail - self.n_frames_done
            if todo < self.FRAME_GROUP:
                break
            g = self.FRAME_GROUP
            while g * 2 <= min(todo, self.MAX_GROUP_FRAMES):
                g *= 2
            s0 = self.n_frames_done * self.frame_shift - self._samples_base
            need = (g - 1) * self.frame_shift + self.frame_len
            self._ingest(_fbank_group(self.samples[s0: s0 + need],
                                      self.rate, self.mel))
            self.n_frames_done += g
        self._trim_samples()

    def flush_tail(self) -> None:
        """Extract the last frames, short of a group (end of stream)."""
        nf = fbank_mod.num_frames(self.n_samples, self.frame_len,
                                  self.frame_shift)
        if nf <= self.n_frames_done:
            return
        s0 = self.n_frames_done * self.frame_shift - self._samples_base
        seg = self.samples[s0: s0 + self.group_samples]
        seg = np.concatenate([seg, np.zeros(
            (self.group_samples - len(seg),), np.float32)])
        feats = _fbank_group(seg, self.rate, self.mel)
        self._ingest(feats[: nf - self.n_frames_done])
        self.n_frames_done = nf
        self._trim_samples()

    def t_total(self) -> int:
        """Encoder positions (conv2d x4) of the frames so far."""
        return ((self.n_frames - 1) // 2 - 1) // 2

    def window(self, f0: int, n: int) -> np.ndarray:
        """The normalised window [<= n, mel] from absolute frame f0
        (short only at the end of a stream; the caller pads). Windows
        are read with f0 never decreasing, so frames behind f0 are
        trimmed here."""
        if self.normalization == "running":
            # fold frames [_nn, f0 + n) into the statistics; window ends
            # only move forward and never past a frame not yet folded
            end = min(f0 + n, self.n_frames)
            if end > self._nn:
                seg = self.frames[self._nn - self._frames_base:
                                  end - self._frames_base
                                  ].astype(np.float64)
                self._nsum += seg.sum(0)
                self._nsumsq += (seg ** 2).sum(0)
                self._nn = end
        cut = f0 - self._frames_base
        if cut > 0:
            self.frames = self.frames[cut:]
            self._frames_base = f0
        w = self.frames[f0 - self._frames_base: f0 - self._frames_base + n]
        if self.normalization != "running" or self._nn == 0:
            return w
        mean = (self._nsum / self._nn).astype(np.float32)
        var = (self._nsumsq / self._nn - (self._nsum / self._nn) ** 2)
        var = np.maximum(var, 0.0).astype(np.float32)
        return (w - mean) / np.sqrt(var + 1e-8)


def check_streamable(model: ASRModel, num_left_chunks: int) -> None:
    """A streaming runtime needs the conv2d x4 input layer (its window is
    4c + 3 frames, as in both JAX runtimes), causal convs and a finite
    history."""
    if model.input_layer != "conv2d":
        raise ValueError("streaming supports the conv2d input layer only "
                         f"(model_conf input_layer: {model.input_layer})")
    if not model.causal:
        raise ValueError("streaming needs a model with causal convs "
                         "(model_conf causal: true)")
    if num_left_chunks < 0:
        raise ValueError(
            "streaming needs a finite left context: pass num_left_chunks "
            ">= ceil(max_utt_frames / chunk_size) to reproduce a "
            "num_left_chunks = -1 model exactly")


def zero_caches(model: ASRModel, batch: int, left: int,
                device: torch.device):
    """Zeroed (k, v, cnn) caches: one [batch, left, H, Dk] K and V
    history and one [batch, K-1, D] conv cache per encoder block."""
    h = model.attention_heads
    shape_kv = (batch, left, h, model.d_model // h)
    shape_cnn = (batch, model.cnn_module_kernel - 1, model.d_model)
    n, dt = model.encoder_num_blocks, model.compute_dtype
    return ([torch.zeros(shape_kv, dtype=dt, device=device)
             for _ in range(n)],
            [torch.zeros(shape_kv, dtype=dt, device=device)
             for _ in range(n)],
            [torch.zeros(shape_cnn, dtype=dt, device=device)
             for _ in range(n)])


class StreamingRecognizer:
    """Single-stream (S = 1) online recognizer on the model's device."""

    def __init__(self, model: ASRModel, *, chunk_size: int = 16,
                 num_left_chunks: int = 4, sample_rate: int = 16000,
                 num_mel_bins: int | None = None, blank_id: int = 0,
                 collect_encoder_out: bool = False,
                 normalization: str = "none",
                 endpoint_config: EndpointConfig | None = None):
        """normalization: "none" feeds raw log-mel frames (models with
        global CMVN, which encode_chunk applies); "running" is the
        causal stand-in for per-utterance normalisation (see
        HostFrontend). collect_encoder_out keeps every chunk's encoder
        rows on the host (tests; a device sync per chunk)."""
        check_streamable(model, num_left_chunks)
        self.model = model
        self.device = next(model.parameters()).device
        self.chunk = chunk_size
        self.left = num_left_chunks * chunk_size
        self.mel = num_mel_bins or model.input_size
        self.blank_id = blank_id
        # feature frames of one chunk of c outputs: 4c + 3 (conv2d x4)
        self.win_frames = 4 * chunk_size + 3
        self.k_caches, self.v_caches, self.cnn_caches = zero_caches(
            model, 1, self.left, self.device)
        self.cache_len = 0
        self.offset = 0          # absolute encoder position
        self.hyp: list[int] = []
        self.times: list[int] = []   # emission position of each token
        self.prev_tok = -1
        self.finished = False
        self.endpointer = Endpointer(endpoint_config, frame_ms=FRAME_MS,
                                     blank_id=blank_id)
        self.fe = HostFrontend(self.mel, sample_rate, normalization)
        self.collect_encoder_out = collect_encoder_out
        self.enc_chunks: list[np.ndarray] = []

    def accept_waveform(self, wav: np.ndarray) -> list[int]:
        """Feed float32 samples (x32768 scaled, as in training); returns
        the tokens the partial CTC result newly emitted."""
        if self.finished:
            # the flush chunk rolled padding into the caches: a stream
            # is one-shot, start a new recognizer
            raise RuntimeError("accept_waveform() after finish()")
        self.fe.accept(wav)
        emitted = []
        while self.fe.n_frames - 4 * self.offset >= self.win_frames:
            emitted += self._run_chunk(self.chunk)
        return emitted

    @torch.inference_mode()
    def _run_chunk(self, valid: int) -> list[int]:
        """One encoder chunk step; valid < chunk only on the final flush
        chunk, whose window is zero-padded to the full width."""
        window = self.fe.window(4 * self.offset, self.win_frames)
        win = torch.zeros((1, self.win_frames, self.mel))
        win[0, : window.shape[0]] = torch.from_numpy(window)
        enc, k_new, v_new, cnn = self.model.encode_chunk(
            win.to(self.device), self.offset, self.k_caches, self.v_caches,
            self.cache_len, self.cnn_caches, valid)
        toks = self.model.ctc_log_probs(enc).argmax(-1)[0]
        if self.left > 0:
            self.k_caches = [torch.cat([kc, kn], 1)[:, -self.left:]
                             for kc, kn in zip(self.k_caches, k_new)]
            self.v_caches = [torch.cat([vc, vn], 1)[:, -self.left:]
                             for vc, vn in zip(self.v_caches, v_new)]
            self.cache_len = min(self.cache_len + self.chunk, self.left)
        self.cnn_caches = cnn
        if self.collect_encoder_out:
            self.enc_chunks.append(enc[0, :valid].cpu().numpy())
        pos0 = self.offset
        self.offset += self.chunk
        frame_toks = toks[:valid].tolist()
        out = []
        for i, t in enumerate(frame_toks):
            if t != self.prev_tok and t != self.blank_id:
                out.append(t)
                self.times.append(pos0 + i)
            self.prev_tok = t
        self.endpointer.feed(frame_toks)
        self.hyp += out
        return out

    def finish(self) -> list[int]:
        """End-of-stream flush (without it the last up to chunk x 40 ms
        + 160 ms of audio never reach the encoder); returns the newly
        emitted tokens. A second call emits nothing."""
        if self.finished:
            return []
        self.finished = True
        self.fe.flush_tail()
        t_total = self.fe.t_total()
        out = []
        while t_total - self.offset > self.chunk:
            out += self._run_chunk(self.chunk)
        if t_total > self.offset:
            out += self._run_chunk(t_total - self.offset)
        return out

    def result(self) -> list[int]:
        return list(self.hyp)

    def result_times_ms(self) -> list[float]:
        """Emission time (onset, ms) of each token of result()."""
        return [p * FRAME_MS for p in self.times]

    def endpoint_detected(self) -> bool:
        """The endpointer's latched decision over the greedy path."""
        return self.endpointer.detected
