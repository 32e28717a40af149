"""Smoke run of openeat_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and turns TF32
   off for the float32 phases. Builds openeat_torch/csrc/*.cu with nvcc,
   one process per source, all started together, and prints each kernel
   entry's registers and spills (ptxas -v); an entry that spills fails.
2. Kernel phase: holds K3 (openeat_torch/csrc/depthwise_conv.cu) against
   depthwise_conv1d_plain on the card, at the decode shape [8, 138, 256]
   K=15, at ragged shapes (C=100 in bfloat16 takes the cp.async route,
   the rest TMA; C=99 in bfloat16 and a bfloat16 input at a 2-byte offset
   take the element-load route), and at the shapes the decode runs below
   give it, in float32 (bit-equal) and bfloat16 (<= 1 bf16 ulp of the
   float32 sum; bit-equal on the element route). Times the kernel, the
   plain version and F.conv1d(groups=C) (the library yardstick, which
   the port never calls) as device time per call from CUDA-graph
   replays over inputs rotated through more than the 50 MB L2, beside
   the least time the card needs for the bytes and operations.
   Then the training kernels, at the shapes the training run below
   gives them, at fixed larger ones and at ragged ones ([3, 40, 100]
   K=7, [1, 15, 4] K=15, whose dgrad has T < K, and the element route):
   K3's dgrad (the kernel's dgrad entry on dy and w as they are; float32
   bit-equal to the plain dgrad, bfloat16 within 1 bf16 ulp) and wgrad
   (one launch; the same bits on two runs; float32 within 1e-5 x
   max|dw| of the plain sum; bfloat16 within 1 bf16 ulp of the kernel's
   own float32 sums), with aten.convolution_backward as their
   yardstick. torch.profiler shows that one call of depthwise_conv1d,
   depthwise_conv1d_dgrad, depthwise_conv1d_wgrad, ctc_dp_shared and
   ctc_dp_global each runs exactly one device kernel. K2's launch plan
   (openeat_ctc_global_plan) must equal ctc.global_plan. Then the CTC
   forward-backward K1/K2 counterparts (openeat_torch/csrc/ctc_loss.cu)
   against the plain recursions, bit for bit in loss and gamma (NEG_INF
   entries equal), with repeats, an infeasible row, len == 1 and an
   input length of T + 5 in every case (K2 also at a tall S = 49 and at
   S = 1001), each beside its bytes bound and its chain bound (T x one
   dependent step, timed by ctc.chain_step_ms). The port's whole CTC op
   (gather, kernel, scatter; forward and backward) is timed beside
   F.ctc_loss forward and backward at the same (B, T, V, L), the
   yardstick the port never calls.
3. Slice phase: writes 16 synthetic 3-8 s wavs, a 4233-entry dict, the
   flagship AIShell Conformer config (examples/aishell/conf/
   train_conformer.yaml model_conf: d=256, 12 blocks, 3+3 decoders) as
   JSON and a model with seeded random weights, then runs
   openeat_torch.bin.recognize on cuda in the four modes at batch 8 and
   beam 10 (greedy, prefix beam and rescoring with --timestamp_file),
   once more in the attention mode with --adaptive_steps 1
   --length_penalty 0.5, and in rescoring and attention with
   compute_dtype bfloat16. Checks that every key is written, that K3
   launched 12 times per encoded batch, and that the timestamp JSONL has
   one row per key with as many times as tokens, nondecreasing and
   below T' x 40 ms. In float32 the encoder output and CTC log-probs
   match a CPU run of the same model (plain path) within ENC_TOL, greedy
   tokens agreeing wherever the CPU top-2 margin exceeds 10 x ENC_TOL.
   The KV cache against recompute: the cached attention search gives
   the full-prefix search's tokens on both batches, decoder_step along
   a fixed prefix matches decoder_logits within ENC_TOL, and its first 4
   steps match a CPU run within ENC_TOL.
4. Breakdown: model load, host collate and each decode stage per batch
   (the attention search with its steps per batch), the device's idle
   share over one rescoring pass and over the attention search, and the
   host time the search spends blocked in its per-step "all finished"
   test (torch.profiler).
5. Training through openeat_torch.bin.train on cuda: 40 wavs of 3-8 s
   with round(3 x seconds) tokens and two of 19.5 s with 120 tokens
   (their batch's T x S history only fits device memory, so K2's
   counterpart runs), a 4-utterance cv set, the flagship config (bf16,
   SpecAugment, dropout 0.1, dynamic 10000-frame batches), 2 epochs;
   then a resume from epoch_1.pt for one epoch, and recognize from
   epoch_2.pt and train.json. Checks finite losses, the files, the
   continued step count, and the launch counts: K3 forward, dgrad and
   wgrad 12 times per train step (forward also 12 per cv batch and per
   decoded batch), one CTC kernel per train step and cv batch, both
   variants used.
6. Recipe, after that training run (examples/aishell/run.sh's order):
   openeat_torch.bin.average_model --val_best --num 2 over its epoch_1
   and epoch_2 (each averaged tensor equal to a float64 host mean),
   openeat_torch.bin.train_lm on cuda at examples/aishell/conf/
   train_lm.yaml's width (as JSON) for 2 epochs on the training and cv
   transcripts (finite losses, files written), a bigram ARPA from the
   training transcripts, then recognize of the cv set from avg_2.pt in
   attention_rescoring unfused, with the Transformer LM (--lm_weight
   0.3) and with the n-gram, each with its CER through
   openeat_torch.utils.wer.corpus_wer (printed, no threshold; random
   transcripts). The fused scores must differ from the unfused ones on
   some candidate, and the LM's float32 log_probs on the card match a
   CPU run within ENC_TOL.
7. One float32 train step, GPU against CPU, on a 4-utterance batch at
   full width (dropout 0, SpecAugment off, TF32 off, same weights).
8. Overfit: 30 steps on one repeated 8-utterance batch (dropout 0,
   SpecAugment off); the mean loss of the last 5 must be below 0.9 x
   the first.
9. Training breakdown at the flagship bf16 setting: frontend, forward,
   backward, clip+optimizer per step (host clock around synchronized
   work), the device's idle share over 5 steps (torch.profiler), peak
   memory and audio seconds trained per second.
10. Streaming (before 7-9), the streaming Conformer of examples/aishell/
   conf/train_conformer_streaming.yaml (causal convs, dynamic chunks;
   static chunk 16 with 4 left chunks for the offline reference) at full
   width with seeded random weights, float32, chunks of 16 positions
   (640 ms) with 4 left chunks, 200 ms pieces. In the kernel phase K3
   runs at the chunk step's shapes [1, 30, 256] and [8, 30, 256] (the
   conv cache in front of the chunk) in both dtypes, by TMA, bit-equal
   to its plain version, timed beside a copy of its input. Then: the
   encoder rows StreamingRecognizer collects for 4 decode wavs match the
   offline chunk-masked encode on the card within rtol 1e-3 / atol 2e-4
   and the streamed greedy result is the offline one (frame argmax equal
   wherever the top-2 margin exceeds 10 x the measured log-prob gap),
   with 12 K3 launches per chunk step at [1, 30, 256] by TMA; one
   stream's rows on the card against the CPU within ENC_TOL;
   StreamingBatch at S = 8 over the 16 wavs with ragged arrivals and
   reused slots against 16 sequential S = 1 runs, by the same rules,
   12 K3 launches per step. openeat_torch.bin.stream_recognize on cuda
   over the 16 wavs with --timestamp_file: --slots 1 greedy (seconds
   per chunk step, p50 and p99 piece latency) and --slots 8
   attention_rescoring (aggregate x-realtime), in float32 and bfloat16.
   The device's idle share over profiled chunk steps at S = 1 and S = 8.
   Then bin.train on the streaming config (bf16, dynamic chunks,
   SpecAugment, dropout) for one epoch of the training corpus, finite
   losses, the launch counts of 5, and stream_recognize --slots 4 of the
   cv set from its checkpoint.
11. Serving and int8 (after 10's stream runs), the same streaming model
   in float32. bin/serve's build_server on cuda, 127.0.0.1, port 0,
   --slots 8, rescoring finals, reverse_weight 0.3: 16 AsrClient
   threads send the decode wavs in 200 ms pieces as fast as the socket
   takes them (8 wait for admission) and one more sends the first wav
   at 8 kHz. Every final's tokens and times_ms equal a direct float16
   StreamingBatch run of the same int16 audio on the card, each
   session's partials concatenate to a prefix of its direct greedy
   path, no error event arrives, and K3 runs 12 times a chunk step at
   [8, 30, 256] float32 by TMA; aggregate x-realtime (first open to last
   final), end-to-final p50/p99, first-partial p50, the smallest top-2
   CTC log-prob margin, and the device's idle share over a second,
   profiled round of the 16 clients. serve_endpoint: one session on
   --endpoint --endpoint_rule3_ms 2000 at the audio's own pace and no
   "end" gets its final with endpoint true after at most 2000 + 640 ms
   of decoded audio. int8: the widened weights on the card bit-equal to
   the CPU's, bin/serve --quantize int8 under the same 16 clients
   (x-realtime; finals equal to float32's counted, not asserted),
   bin/recognize --quantize int8 on the flagship (attention_rescoring,
   batch 8, RTF), and its greedy tokens on 4 wavs equal to a CPU run's.

Any failed check raises. Before the last two stdout lines it prints the
card's name and power limit again; then the kernels line (each kernel's
launches on the main path, error, times and bounds; the CTC rows with
their chain bound; K3 once more at each chunk-step shape with the
stream runs' launches there) and the JSON result. Details go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import copy
import ctypes
import json
import math
import os
import shutil
import statistics
import subprocess
import threading
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from openeat_torch.bin import (average_model, recognize, stream_recognize,
                               train_lm)
from openeat_torch.bin import serve as serve_cli
from openeat_torch.bin import train as train_cli
from openeat_torch.dataset.audio import read_wav, resample, write_wav
from openeat_torch.dataset.dataset import (AudioCollate, AudioDataset,
                                           PrefetchLoader)
from openeat_torch.dataset.text import load_dict
from openeat_torch.decode import attention_beam
from openeat_torch.decode.attention_beam import recognize as attention_decode
from openeat_torch.decode.ctc_greedy import ctc_greedy_search
from openeat_torch.decode.rescoring import (attention_rescoring,
                                            rescoring_scores)
from openeat_torch.decode.ctc_prefix_beam import (ctc_prefix_beam_search,
                                                  prefix_beam_init,
                                                  prefix_beam_step)
from openeat_torch.decode.streaming import (FRAME_MS, StreamingRecognizer,
                                            zero_caches)
from openeat_torch.decode.streaming_batch import StreamingBatch
from openeat_torch.lm.ngram import load_lm as load_ngram
from openeat_torch.models.asr_model import build_asr_model, init_parameters
from openeat_torch.modules import convolution as conv_module
from openeat_torch.modules.dropout import set_generator
from openeat_torch.modules.layers import Dense
from openeat_torch.ops import ctc_loss as ctc
from openeat_torch.ops import depthwise_conv as dw
from openeat_torch.ops import fbank as fbank_mod
from openeat_torch.ops import nvcc
from openeat_torch.ops.frontend import FrontendConfig, compute_features
from openeat_torch.parallel.train_step import (TrainState, apply_update,
                                               build_train_step)
from openeat_torch.pipeline import DeviceFeeder
from openeat_torch.runtime.client import AsrClient
from openeat_torch.runtime.server import recv_frame, send_json
from openeat_torch.utils.common import make_generator
from openeat_torch.utils.optim import build_optimizer
from openeat_torch.utils.quantize import quantized_bytes
from openeat_torch.utils.wer import corpus_wer

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke_work")
OUT_DIR = os.path.join(REPO, "chiprun_out")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and float32
# outside the tensor cores, where K3 does its multiply-adds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
L2_BYTES = 50 * 2 ** 20

SEED = 20261016
N_UTTS = 16
BATCH = 8
VOCAB = 4233
ENC_TOL = 2e-3  # float32 GPU vs CPU, TF32 off: summation order only
FLAGSHIP_MODEL_CONF = {
    "d_model": 256, "attention_heads": 4, "linear_units": 1024,
    "input_layer": "conv2d", "pos_enc_layer_type": "rel_pos",
    "encoder_num_blocks": 12, "encoder_num_blocks_share": 1,
    "macaron_style": True, "use_cnn_module": True, "cnn_module_kernel": 15,
    "causal": False, "decoder_num_blocks": 3, "r_decoder_num_blocks": 3,
    "decoder_num_blocks_share": 1, "activation": "swish",
    "compute_dtype": "float32",
}
MODES = ["ctc_greedy_search", "ctc_prefix_beam_search", "attention",
         "attention_rescoring"]
BEAM = 10
MAX_HYP_LEN = 64
# examples/aishell/conf/train_conformer.yaml as JSON (the card machine has
# no PyYAML), with a short warmup and two epochs for the smoke run
TRAIN_CONFIG = {
    "model_conf": dict(FLAGSHIP_MODEL_CONF, compute_dtype="bfloat16",
                       r_decoder_num_blocks=3, dropout_rate=0.1,
                       ctc_weight=0.3, lsm_weight=0.1, reverse_weight=0.3,
                       length_normalized_loss=False, ctc_impl="optax"),
    "collate_conf": {
        "feature_extraction_conf": {"resample_rate": 16000, "mel_bins": 80,
                                    "speed_perturb_rate": 0,
                                    "wav_dither": 0.0},
        "feature_dither": 0.0, "spec_sub": False, "spec_aug": True,
        "spec_aug_conf": {"num_t_mask": 3, "num_f_mask": 2, "max_t": 50,
                          "max_f": 10}},
    "dataset_conf": {"speed_perturb": False, "max_length": 2000,
                     "min_length": 10, "batch_type": "dynamic",
                     "max_frames_in_batch": 10000, "batch_size": 12,
                     "sort": True},
    "grad_clip": 5, "accum_grad": 1, "max_epoch": 2, "log_interval": 1,
    "optim": "adam", "optim_conf": {"lr": 0.001}, "warmup_steps": 4,
    "seed": SEED,
}
N_TRAIN = 40           # 3-8 s, round(3 x seconds) tokens
LONG_SECONDS, LONG_TOKENS = 19.5, 120
N_CV = 4
STEP_LOSS_TOL = 1e-5   # float32 GPU vs CPU train step, relative
STEP_GRAD_TOL = 1e-3   # per tensor, of its max |grad|


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing

def device_ms(fn, n_inputs: int, reps: int = 7) -> float:
    """Median device time of one call. `fn(i)` runs the call on input
    copy i; a CUDA graph holds one call per copy, so the host's launch
    cost is out of the measurement and each call finds its input cold."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(min(3, n_inputs)):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_inputs):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n_inputs)
    return statistics.median(times)


def bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each float32 value: 2**(exponent - 8) for
    |ref| = m * 2**exponent, 0.5 <= m < 1 (8 significant bits)."""
    _, exp = torch.frexp(ref)
    return torch.ldexp(torch.ones_like(ref), exp - 8)


# ---------------------------------------------------------------- kernel

def offset_view(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `t` one element past a buffer's start: for
    bfloat16 an address 2 bytes off every 4-byte boundary, which only
    K3's element-load route takes."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def kernel_case(b: int, tp: int, c: int, k: int, dtype, gen,
                offset: bool = False, exact: bool = False) -> dict:
    """K3's forward against its plain version; times it, a copy of its
    input, the plain version and the library call, unless `offset` (the
    input at a 2-byte offset, checked only). `exact` asks bit-equality
    in bfloat16 too."""
    dev = torch.device("cuda")
    x32 = torch.randn((b, tp, c), generator=gen, device=dev)
    w32 = torch.randn((k, c), generator=gen, device=dev) * 0.3
    x, w = x32.to(dtype), w32.to(dtype)
    if offset:
        x = offset_view(x)
    out = dw.depthwise_conv1d(x, w)
    plain = dw.depthwise_conv1d_plain(x, w)
    torch.cuda.synchronize()
    assert out.shape == (b, tp - k + 1, c) and out.dtype == dtype
    err = (out.float() - plain.float()).abs()
    row = {"shape": [b, tp, c], "k": k, "dtype": str(dtype).split(".")[-1],
           "route": dw.device_plan(x, k, dgrad=False).route,
           "offset_bytes": x.data_ptr() % 16, "max_abs_err": float(err.max())}
    if dtype == torch.float32 or exact:
        ok = row["max_abs_err"] == 0.0
    else:
        ulp = bf16_ulp(dw.depthwise_conv1d_plain(x.float(), w.float()))
        row["max_err_ulps"] = float((err / ulp).max())
        ok = row["max_err_ulps"] <= 1.0
    if not ok:
        raise AssertionError(f"K3 disagrees with its plain version: {row}")
    if offset:
        return row

    t_out = tp - k + 1
    item = x.element_size()
    nbytes = (x.numel() + w.numel() + b * t_out * c) * item
    flops = 2 * b * t_out * c * k
    n_inputs = max(2, min(64, math.ceil(2 * L2_BYTES / nbytes)))
    xs = [x.clone() for _ in range(n_inputs)]
    x_ncw = [xi.transpose(1, 2).contiguous() for xi in xs]
    w_conv = w.t().contiguous()[:, None, :]           # [C, 1, K]
    lib = F.conv1d(x_ncw[0], w_conv, groups=c)
    row["library_max_abs_err"] = float(
        (lib.transpose(1, 2).float() - plain.float()).abs().max())
    row["ms"] = device_ms(lambda i: dw.depthwise_conv1d(xs[i], w), n_inputs)
    dst = [torch.empty_like(xi) for xi in xs]
    row["copy_ms"] = device_ms(lambda i: dst[i].copy_(xs[i]), n_inputs)
    row["plain_ms"] = device_ms(
        lambda i: dw.depthwise_conv1d_plain(xs[i], w), n_inputs)
    row["library_ms"] = device_ms(
        lambda i: F.conv1d(x_ncw[i], w_conv, groups=c), n_inputs)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    row["bound_ms"] = max(bytes_ms, ops_ms)
    row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return row


def main_path_shapes(durations: list[float]) -> list[tuple]:
    """K3's input shapes in the decode runs: static batches of the
    duration-sorted utterances, wavs padded to whole seconds, fbank
    frames (25 ms / 10 ms), conv2d x4 subsampling, + (K - 1) padding."""
    n = sorted(int(d * 16000) for d in durations)
    shapes = []
    for i in range(0, len(n), BATCH):
        padded = math.ceil(max(n[i:i + BATCH]) / 16000) * 16000
        frames = (padded - 400) // 160 + 1
        t_enc = ((frames - 3) // 2 + 1 - 3) // 2 + 1
        shapes.append((BATCH, t_enc + 14, 256, 15))
    return shapes


# ---------------------------------------------------------------- slice

def write_corpus(rng: np.random.Generator) -> tuple[str, str, list]:
    wav_dir = os.path.join(WORK, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    vocab = ["<blank>", "<unk>"] + [chr(0x4E00 + i) for i in range(VOCAB - 3)] \
        + ["<sos/eos>"]
    dict_path = os.path.join(WORK, "dict.txt")
    with open(dict_path, "w", encoding="utf-8") as f:
        f.writelines(f"{tok} {i}\n" for i, tok in enumerate(vocab))
    lines, durations = [], []
    for i in range(N_UTTS):
        dur = float(np.round(rng.uniform(3.0, 8.0), 3))
        t = np.arange(int(dur * 16000)) / 16000.0
        x = sum(0.1 * np.sin(2 * np.pi * rng.uniform(80, 3000) * t)
                for _ in range(3)) + 0.02 * rng.standard_normal(t.size)
        path = os.path.join(wav_dir, f"utt{i:03d}.wav")
        write_wav(path, x.astype(np.float32), 16000)
        text = "".join(vocab[j] for j in rng.integers(2, VOCAB - 1, 12))
        lines.append(f"utt:utt{i:03d}\tfeat:{path}\tfeat_shape:{dur:.3f}\t"
                     f"text:{text}\n")
        durations.append(dur)
    manifest = os.path.join(WORK, "format.data")
    with open(manifest, "w", encoding="utf-8") as f:
        f.writelines(lines)
    return manifest, dict_path, durations


def write_config(compute_dtype: str) -> str:
    cfg = {"model_conf": dict(FLAGSHIP_MODEL_CONF,
                              compute_dtype=compute_dtype),
           "vocab_size": VOCAB, "input_size": 80,
           "collate_conf": {"feature_extraction_conf": {"mel_bins": 80},
                            "spec_aug": True},
           "dataset_conf": {"max_length": 2000, "min_length": 10}}
    path = os.path.join(WORK, f"train_{compute_dtype}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def random_model_state(gen: torch.Generator,
                       conf: dict = FLAGSHIP_MODEL_CONF) -> dict:
    """Full-width model with weights drawn from `gen`: matrices scaled by
    1/sqrt(fan_in), LayerNorm gains near 1, small biases."""
    model = build_asr_model(conf, 80, VOCAB)
    with torch.no_grad():
        for name, p in model.named_parameters():
            z = torch.randn(p.shape, generator=gen)
            if name.endswith("embed.weight"):
                p.copy_(z)
            elif name.endswith("depthwise_conv.weight"):
                p.copy_(z / math.sqrt(p.shape[0]))
            elif p.dim() >= 2 and "pos_bias" not in name:
                p.copy_(z / math.sqrt(p[0].numel()))
            elif p.dim() == 1 and name.endswith(".weight"):  # LayerNorm
                p.copy_(1.0 + 0.05 * z)
            else:
                p.copy_(0.05 * z)
    return model.state_dict()


def run_recognize(cfg: str, ckpt: str, manifest: str, dict_path: str,
                  mode: str, tag: str, extra=(), timestamps: bool = False
                  ) -> tuple[dict, float, int, list | None]:
    """recognize on cuda with K3's count set to 0 just before and read
    just after. Returns (hyps by key, wall s, K3 launches, the
    --timestamp_file rows when `timestamps`)."""
    out = os.path.join(WORK, f"hyp_{tag}.txt")
    ts_path = os.path.join(WORK, f"ts_{tag}.jsonl")
    ts_args = ["--timestamp_file", ts_path] if timestamps else []
    dw.depthwise_conv1d.launches = 0
    t0 = time.perf_counter()
    recognize.main(["--config", cfg, "--checkpoint", ckpt, "--test_data",
                    manifest, "--dict", dict_path, "--result_file", out,
                    "--mode", mode, "--batch_size", str(BATCH),
                    "--beam_size", str(BEAM), "--max_hyp_len",
                    str(MAX_HYP_LEN), "--reverse_weight", "0.3",
                    "--device", "cuda", *ts_args, *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dw.depthwise_conv1d.launches
    with open(out, encoding="utf-8") as f:
        hyps = dict((line.rstrip("\n").split(" ", 1) + [""])[:2]
                    for line in f)
    rows = None
    if timestamps:
        with open(ts_path, encoding="utf-8") as f:
            rows = [json.loads(line) for line in f]
    return hyps, wall, launches, rows


def encoder_frames(seconds: float) -> int:
    """Encoder positions of a wav of `seconds`: fbank frames (25 ms /
    10 ms) through the conv2d x4 subsampling."""
    frames = (int(seconds * 16000) - 400) // 160 + 1
    return ((frames - 3) // 2 + 1 - 3) // 2 + 1


def check_timestamps(tag: str, rows: list, hyps: dict,
                     t_enc: dict) -> dict:
    """One JSONL row per key, as many times as tokens, nondecreasing and
    inside the utterance (below T' x 40 ms)."""
    if sorted(r["key"] for r in rows) != sorted(hyps):
        raise AssertionError(f"{tag}: timestamp keys "
                             f"{[r['key'] for r in rows]}")
    n_tokens = 0
    for r in rows:
        times = r["times_ms"]
        if len(times) != len(r["tokens"]) or times != sorted(times) \
                or any(not 0 <= t < t_enc[r["key"]] * 40.0 for t in times):
            raise AssertionError(f"{tag}: bad timestamps {r}")
        n_tokens += len(times)
    return {"rows": len(rows), "tokens": n_tokens}


def compare_with_cpu(cfg_path: str, ckpt: str, manifest: str,
                     dict_path: str) -> dict:
    """First batch: GPU (K3) vs CPU (plain) frontend, encoder and CTC."""
    cfg = json.load(open(cfg_path))
    gpu = recognize.load_model(cfg, ckpt, VOCAB, torch.device("cuda"))
    cpu = recognize.load_model(cfg, ckpt, VOCAB, torch.device("cpu"))
    ds = AudioDataset(manifest, load_dict(dict_path), batch_size=BATCH)
    feeds = {}
    for dev in ("cuda", "cpu"):
        feeder = DeviceFeeder(PrefetchLoader(ds, AudioCollate()),
                              FrontendConfig(), torch.device(dev), BATCH)
        feeds[dev] = next(iter(feeder))[1]
    feats = feeds["cuda"]["features"]
    lens = feeds["cuda"]["features_length"]
    with torch.inference_mode():
        g_enc, g_lens = gpu.encode(feats, lens)
        g_lp = gpu.ctc_log_probs(g_enc)
        c_enc, c_lens = cpu.encode(feats.cpu(), lens.cpu())
        c_lp = cpu.ctc_log_probs(c_enc)
    for t in (g_enc, g_lp):
        assert torch.isfinite(t).all(), "non-finite encoder/CTC output"
    assert g_enc.shape == (BATCH, g_enc.shape[1], 256)
    assert g_lp.shape == g_enc.shape[:2] + (VOCAB,)
    assert torch.equal(g_lens.cpu(), c_lens)
    valid = (torch.arange(c_enc.shape[1])[None, :] < c_lens[:, None])
    res = {
        "feature_max_abs_err": float((feeds["cuda"]["features"].cpu()
                                      - feeds["cpu"]["features"]).abs().max()),
        "encoder_max_abs_err": float((g_enc.cpu() - c_enc).abs()[valid].max()),
        "ctc_logp_max_abs_err": float((g_lp.cpu() - c_lp).abs()[valid].max()),
    }
    top2 = c_lp.topk(2, dim=-1).values
    sure = valid & (top2[..., 0] - top2[..., 1] > 10 * ENC_TOL)
    agree = g_lp.argmax(-1).cpu() == c_lp.argmax(-1)
    res["greedy_frames_checked"] = int(sure.sum())
    res["greedy_frames_valid"] = int(valid.sum())
    res["greedy_disagreements"] = int((sure & ~agree).sum())
    if res["encoder_max_abs_err"] > ENC_TOL \
            or res["ctc_logp_max_abs_err"] > ENC_TOL \
            or res["greedy_disagreements"]:
        raise AssertionError(f"GPU decode path disagrees with CPU: {res}")
    return res


def stage_breakdown(cfg_path: str, ckpt: str, manifest: str,
                    dict_path: str, dev: torch.device) -> dict:
    """Where a decode run's time goes: model load, host collate, and
    each device stage per batch (host clock around synchronized work,
    median of 3 passes over both batches), the attention search's steps
    among them; then the device's busy share over one full
    attention_rescoring pass, and over one attention search of both
    batches with the host time blocked in its per-step "all finished"
    test (torch.profiler's aten::_local_scalar_dense, the search's only
    host sync) and the operators it dispatches a step, from
    torch.profiler's kernel, copy and operator events."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    model = recognize.load_model(json.load(open(cfg_path)), ckpt, VOCAB, dev)
    torch.cuda.synchronize()
    out = {"model_load_s": time.perf_counter() - t0}
    ds = AudioDataset(manifest, load_dict(dict_path), batch_size=BATCH)
    t0 = time.perf_counter()
    host = [AudioCollate()(ds[i])[1] for i in range(len(ds))]
    out["host_collate_s_per_batch"] = (time.perf_counter() - t0) / len(ds)
    wavs = [(torch.from_numpy(b["wav"]).to(dev),
             torch.from_numpy(b["wav_lens"]).to(dev)) for b in host]
    fe = FrontendConfig()
    steps = [0]
    step_fn = model.decoder_step

    def counted_step(*args):
        steps[0] += 1
        return step_fn(*args)

    model.decoder_step = counted_step

    def attention(enc, enc_lens):
        attention_decode(model, enc, enc_lens, beam_size=BEAM,
                         max_steps=min(int(enc.shape[1]), MAX_HYP_LEN))

    def one_pass(lap):
        for wav, lens in wavs:
            feats, flens = compute_features(wav, lens, fe)
            lap("frontend")
            enc, enc_lens = model.encode(feats, flens)
            lap("encode")
            lp = model.ctc_log_probs(enc)
            lap("ctc_head")
            ctc_greedy_search(lp, enc_lens)
            lap("greedy_search")
            nbest = ctc_prefix_beam_search(lp, enc_lens, beam_size=BEAM,
                                           max_hyp_len=MAX_HYP_LEN)
            lap("prefix_beam_search")
            attention_rescoring(model, enc, enc_lens, *nbest,
                                ctc_weight=0.5, reverse_weight=0.3)
            lap("rescoring")
            attention(enc, enc_lens)
            lap("attention_search")

    totals: dict[str, list] = {}
    with torch.inference_mode():
        for _ in range(3):
            run = {}
            clock = [time.perf_counter()]

            def lap(name):
                torch.cuda.synchronize()
                now = time.perf_counter()
                run[name] = run.get(name, 0.0) + now - clock[0]
                clock[0] = now

            torch.cuda.synchronize()
            clock[0] = time.perf_counter()
            steps[0] = 0
            one_pass(lap)
            for name, sec in run.items():
                totals.setdefault(name, []).append(sec / len(wavs))
        out["stage_s_per_batch"] = {k: statistics.median(v)
                                    for k, v in totals.items()}
        out["attention_steps_per_batch"] = steps[0] / len(wavs)
        out["attention_s_per_step"] = (out["stage_s_per_batch"][
            "attention_search"] / out["attention_steps_per_batch"])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_pass(lambda name: None)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        encoded = [model.encode(*compute_features(w, n, fe)) for w, n in wavs]
        torch.cuda.synchronize()
        steps[0] = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as aprof:
            t0 = time.perf_counter()
            for enc, enc_lens in encoded:
                attention(enc, enc_lens)
            torch.cuda.synchronize()
            attn_wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = _device_busy_us(prof)
    out["profiled_wall_s"] = wall_us / 1e6
    out["device_busy_s"] = busy_us / 1e6
    # no device events means the profiler could not trace the card
    out["device_idle_share"] = 1.0 - busy_us / wall_us if busy_us else None
    attn_busy = _device_busy_us(aprof)
    sync_us = sum(e.cpu_time_total for e in aprof.events()
                  if e.name == "aten::_local_scalar_dense")
    # operators the host dispatches (top-level aten calls, views and
    # no-op casts included): what a step costs the host
    host_ops = sum(1 for e in aprof.events() if e.cpu_parent is None
                   and e.name.startswith("aten::"))
    out["attention_search"] = {
        "host_ops_per_step": host_ops / steps[0],
        "wall_s_per_batch": attn_wall_us / 1e6 / len(wavs),
        "device_busy_s_per_batch": attn_busy / 1e6 / len(wavs),
        "device_idle_share": (1.0 - attn_busy / attn_wall_us
                              if attn_busy else None),
        "host_sync_s_per_batch": sync_us / 1e6 / len(wavs)}
    return out


def _device_busy_us(prof) -> float:
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def attention_cache_checks(cfg_path: str, ckpt: str, manifest: str,
                           dict_path: str) -> dict:
    """The KV cache against recompute on the card, float32: the cached
    beam search gives the full-prefix search's tokens on both batches;
    decoder_step along a fixed prefix (the first batch's best
    hypotheses) matches decoder_logits within ENC_TOL; its first 4
    steps match a CPU run of the same weights within ENC_TOL."""
    cfg = json.load(open(cfg_path))
    gpu = recognize.load_model(cfg, ckpt, VOCAB, torch.device("cuda"))
    cpu = recognize.load_model(cfg, ckpt, VOCAB, torch.device("cpu"))
    ds = AudioDataset(manifest, load_dict(dict_path), batch_size=BATCH)
    feeder = DeviceFeeder(PrefetchLoader(ds, AudioCollate()),
                          FrontendConfig(), torch.device("cuda"), BATCH)
    out = {"searches": []}
    with torch.inference_mode():
        for i, (_, batch) in enumerate(feeder):
            enc, lens = gpu.encode(batch["features"],
                                   batch["features_length"])
            steps = min(int(enc.shape[1]), MAX_HYP_LEN)
            cached = attention_beam.attention_beam_search_cached(
                gpu, enc, lens, beam_size=BEAM, max_steps=steps)
            full = attention_decode(gpu, enc, lens, beam_size=BEAM,
                                    max_steps=steps, use_cache=False)
            row = {"batch": i, "max_steps": steps,
                   "tokens_equal": bool(torch.equal(cached[0], full[0])
                                        and torch.equal(cached[1], full[1])),
                   "score_max_abs_diff": float((cached[2] - full[2]).abs()
                                               .max()),
                   "mean_len": float(cached[1].float().mean())}
            out["searches"].append(row)
            if not row["tokens_equal"]:
                raise AssertionError(f"cached and full-prefix attention "
                                     f"searches differ: {row}")
            if i == 0:
                first = (enc, lens, cached[0])
        enc, lens, hyps = first
        b, t = enc.shape[:2]
        ys = torch.cat([torch.full((b, 1), gpu.sos, device=enc.device),
                        torch.where(hyps < 0, gpu.eos, hyps)], dim=1)
        n_pos = ys.shape[1]
        full = gpu.decoder_logits(enc, lens, ys, torch.full((b,), n_pos,
                                                            device=enc.device))
        cache = gpu.decoder_init_cache(enc, b, n_pos)
        cpu_cache = cpu.decoder_init_cache(enc.cpu(), b, n_pos)
        step_err = cpu_err = 0.0
        for pos in range(n_pos):
            lp, cache = gpu.decoder_step(ys[:, pos], pos, cache, lens, t)
            step_err = max(step_err, float((lp - full[:, pos]).abs().max()))
            if pos < 4:
                c_lp, cpu_cache = cpu.decoder_step(ys[:, pos].cpu(), pos,
                                                   cpu_cache, lens.cpu(), t)
                cpu_err = max(cpu_err, float((lp.cpu() - c_lp).abs().max()))
    out.update(prefix_positions=n_pos, step_vs_full_max_abs_err=step_err,
               step_gpu_vs_cpu_max_abs_err=cpu_err)
    if step_err > ENC_TOL or cpu_err > ENC_TOL:
        raise AssertionError(f"decoder_step disagrees: {out}")
    return out


# ---------------------------------------------------------------- recipe

# examples/aishell/conf/train_lm.yaml as JSON, two epochs
LM_CONFIG = {
    "model_conf": {"d_model": 256, "attention_heads": 4,
                   "linear_units": 1024, "num_blocks": 6,
                   "dropout_rate": 0.1, "activation": "relu",
                   "autoregressive": True, "lsm_weight": 0.1,
                   "compute_dtype": "bfloat16"},
    "dataset_conf": {"token_max_length": 200, "token_min_length": 0,
                     "batch_size": 64, "sort": True},
    "grad_clip": 5, "max_epoch": 2, "log_interval": 1, "optim": "adam",
    "optim_conf": {"lr": 0.001}, "warmup_epoch": 2, "seed": SEED,
}
LM_WEIGHT = 0.3


def manifest_texts(manifest: str) -> dict:
    """{key: text} of a manifest's `utt:` and `text:` fields."""
    out = {}
    with open(manifest, encoding="utf-8") as f:
        for line in f:
            fields = dict(x.split(":", 1) for x in line.rstrip("\n")
                          .split("\t"))
            out[fields["utt"]] = fields["text"]
    return out


def write_text(texts: dict, name: str) -> str:
    path = os.path.join(WORK, name)
    with open(path, "w", encoding="utf-8") as f:
        f.writelines(f"{k} {v}\n" for k, v in texts.items())
    return path


def write_arpa(texts: list, path: str) -> None:
    """A bigram ARPA over the characters of `texts`: relative
    frequencies, half the mass kept for backoff."""
    uni, bi, ctx = Counter(), Counter(), Counter()
    for text in texts:
        toks = ["<s>", *text, "</s>"]
        uni.update(toks[1:])
        ctx.update(toks[:-1])
        bi.update(zip(toks, toks[1:]))
    total = sum(uni.values())
    half = math.log10(0.5)
    lines = ["\\data\\", f"ngram 1={len(uni) + 2}", f"ngram 2={len(bi)}",
             "", "\\1-grams:", f"-99\t<s>\t{half:.6f}",
             f"{math.log10(0.5 / total):.6f}\t<unk>"]
    lines += [f"{math.log10(c / total):.6f}\t{w}\t{half:.6f}"
              for w, c in sorted(uni.items())]
    lines += ["", "\\2-grams:"]
    lines += [f"{math.log10(0.5 * c / ctx[a]):.6f}\t{a} {b}"
              for (a, b), c in sorted(bi.items())]
    lines += ["", "\\end\\", ""]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))


def run_recipe(exp: str, train_data: str, cv_data: str,
               dict_path: str) -> dict:
    """The recipe after training: average_model --val_best --num 2 over
    the run's epoch_1/epoch_2 (held to a float64 host mean), train_lm on
    cuda for 2 epochs on the transcripts, then recognize of the cv set
    from avg_2.pt in attention_rescoring with the Transformer LM fused
    and with the n-gram fused, and the CER of each decode. K3's count is
    set to 0 before the decodes and read after them."""
    out = {}
    avg_path = average_model.main(["--exp_dir", exp, "--dst", "avg_2",
                                   "--num", "2", "--val_best"])
    avg = torch.load(avg_path, weights_only=True)
    epochs = [torch.load(os.path.join(exp, f"epoch_{e}.pt"),
                         weights_only=True) for e in (1, 2)]
    for k, v in avg.items():
        ref = ((epochs[0][k].double() + epochs[1][k].double()) / 2).float() \
            if v.is_floating_point() else epochs[1][k]
        if not torch.equal(v, ref):
            raise AssertionError(f"average_model: {k} is not the mean")
    out["averaged_tensors"] = len(avg)

    train_texts, cv_texts = manifest_texts(train_data), manifest_texts(cv_data)
    lm_cfg = os.path.join(WORK, "train_lm.json")
    with open(lm_cfg, "w") as f:
        json.dump(LM_CONFIG, f)
    lm_exp = os.path.join(WORK, "exp_lm")
    t0 = time.perf_counter()
    lm_state = train_lm.main([
        "--config", lm_cfg, "--train_data", write_text(train_texts, "lm_tr"),
        "--cv_data", write_text(cv_texts, "lm_cv"), "--dict", dict_path,
        "--exp_dir", lm_exp, "--device", "cuda", "--num_workers", "2"])
    torch.cuda.synchronize()
    out["train_lm_wall_s"] = time.perf_counter() - t0
    with open(os.path.join(lm_exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    out["lm_step_losses"] = [r["loss"] for r in records
                             if r["kind"] == "train"]
    out["lm_cv_losses"] = [r["cv_loss"] for r in records
                           if r["kind"] == "epoch"]
    if len(out["lm_step_losses"]) != lm_state.step or not all(
            math.isfinite(x) for x in out["lm_step_losses"]
            + out["lm_cv_losses"]):
        raise AssertionError(f"train_lm losses: {records}")
    for name in ("epoch_1.pt", "epoch_1.json", "epoch_2.pt", "epoch_2.json",
                 "train.json"):
        if not os.path.exists(os.path.join(lm_exp, name)):
            raise AssertionError(f"train_lm did not write {name}")
    arpa = os.path.join(WORK, "lm.arpa")
    write_arpa(list(train_texts.values()), arpa)

    cfg = os.path.join(exp, "train.json")
    lm_args = ["--lm_config", os.path.join(lm_exp, "train.json"),
               "--lm_checkpoint", os.path.join(lm_exp, "epoch_2.pt"),
               "--lm_weight", str(LM_WEIGHT)]
    ngram_args = ["--ngram_lm", arpa, "--lm_weight", str(LM_WEIGHT)]
    n_batches = math.ceil(len(cv_texts) / BATCH)
    out["decodes"] = []
    launches = 0
    for tag, extra in (("recipe_rescoring", []), ("recipe_lm", lm_args),
                       ("recipe_ngram", ngram_args)):
        hyps, wall, k3, _ = run_recognize(cfg, avg_path, cv_data, dict_path,
                                          "attention_rescoring", tag, extra)
        launches += k3
        if set(hyps) != set(cv_texts) or k3 != 12 * n_batches:
            raise AssertionError(f"{tag}: keys {sorted(hyps)}, K3 {k3}")
        cer = corpus_wer(cv_texts, hyps)
        row = {"run": tag, "wall_s": wall, "k3_launches": k3,
               "cer": cer.wer, "ref_chars": cer.ref_len}
        out["decodes"].append(row)
        print("recipe decode " + json.dumps(row), flush=True)
    out["k3_launches"] = launches
    out["fusion"] = fusion_checks(cfg, avg_path, lm_exp, arpa, cv_data,
                                  dict_path)
    return out


def fusion_checks(cfg_path: str, ckpt: str, lm_exp: str, arpa: str,
                  cv_data: str, dict_path: str) -> dict:
    """On the cv batch: the LM-fused rescoring scores differ from the
    unfused ones on at least one candidate, and some candidate has a
    nonzero n-gram term; the LM's float32 log_probs on the card match a
    CPU run within ENC_TOL. The scores are taken at ctc_weight 0: a
    model this briefly trained can leave near-uniform CTC posteriors
    whose prefix beams all die at -1e30, which would swamp every other
    term in float32."""
    dev = torch.device("cuda")
    char_dict = load_dict(dict_path)
    id2tok = {v: k for k, v in char_dict.items()}
    model = recognize.load_model(json.load(open(cfg_path)), ckpt, VOCAB, dev)
    lm_cfg = json.load(open(os.path.join(lm_exp, "train.json")))
    lm_ckpt = os.path.join(lm_exp, "epoch_2.pt")
    lm = recognize.load_language_model(lm_cfg, lm_ckpt, len(char_dict), dev)
    ngram = load_ngram(arpa)
    ds = AudioDataset(cv_data, char_dict, batch_size=BATCH)
    feeder = DeviceFeeder(PrefetchLoader(ds, AudioCollate()),
                          FrontendConfig(), dev, BATCH)
    with torch.inference_mode():
        _, batch = next(iter(feeder))
        enc, lens = model.encode(batch["features"], batch["features_length"])
        nbest = ctc_prefix_beam_search(model.ctc_log_probs(enc), lens,
                                       beam_size=BEAM,
                                       max_hyp_len=MAX_HYP_LEN)
        kw = dict(ctc_weight=0.0, reverse_weight=0.3)
        plain = rescoring_scores(model, enc, lens, *nbest, **kw)
        fused = rescoring_scores(model, enc, lens, *nbest, **kw,
                                 lm_logp_fn=lm.log_probs,
                                 lm_weight=LM_WEIGHT)
        hyps, hyp_lens = nbest[0].cpu(), nbest[1].cpu()
        ngram_terms = [[ngram.score(" ".join(
            id2tok.get(int(t), "<unk>") for t in hyps[b, k, :hyp_lens[b, k]]))
            for k in range(hyps.shape[1])] for b in range(hyps.shape[0])]
        f32_conf = dict(lm_cfg["model_conf"], compute_dtype="float32")
        lm_f32 = {d: recognize.load_language_model(
            dict(lm_cfg, model_conf=f32_conf), lm_ckpt, len(char_dict),
            torch.device(d)) for d in ("cuda", "cpu")}
        ys = torch.cat([torch.full((hyps.shape[0], 1), lm.sos),
                        torch.where(hyps[:, 0] < 0, lm.eos, hyps[:, 0])], 1)
        ys_lens = hyp_lens[:, 0] + 1
        g_lp = lm_f32["cuda"].log_probs(ys.to(dev), ys_lens.to(dev))
        c_lp = lm_f32["cpu"].log_probs(ys, ys_lens)
    res = {"lm_fused_candidates_changed": int(((fused - plain).abs() > 0)
                                              .sum()),
           "candidates": int(plain.numel()),
           "dead_prefix_beams": int((nbest[2] <= -1e29).sum()),
           "ngram_nonzero_terms": sum(t != 0 for row in ngram_terms
                                      for t in row),
           "lm_f32_gpu_vs_cpu_max_abs_err": float(
               (g_lp.cpu() - c_lp).abs().max())}
    if not res["lm_fused_candidates_changed"] \
            or not res["ngram_nonzero_terms"] \
            or res["lm_f32_gpu_vs_cpu_max_abs_err"] > ENC_TOL:
        raise AssertionError(f"LM fusion checks: {res}")
    return res


# ---------------------------------------------------------------- stream

CHUNK, LEFT_CHUNKS = 16, 4     # bin/stream_recognize's defaults: 640 ms
PIECE_MS = 200
# examples/aishell/conf/train_conformer_streaming.yaml's model_conf (causal
# convs, dynamic chunks) with the static chunk that the offline reference
# masks with, so that its offline forward is what the stream reproduces
STREAM_MODEL_CONF = dict(FLAGSHIP_MODEL_CONF, causal=True,
                         use_dynamic_chunk=True, static_chunk_size=CHUNK,
                         num_left_chunks=LEFT_CHUNKS)
# its training as JSON, with the smoke's batches and warmup, one epoch
STREAM_TRAIN_CONFIG = dict(
    TRAIN_CONFIG, max_epoch=1,
    model_conf=dict(TRAIN_CONFIG["model_conf"], causal=True,
                    use_dynamic_chunk=True))
STREAM_TOL = (1e-3, 2e-4)   # rtol, atol: tests/test_streaming.py's


def write_stream_config(compute_dtype: str) -> str:
    cfg = {"model_conf": dict(STREAM_MODEL_CONF, compute_dtype=compute_dtype),
           "vocab_size": VOCAB, "input_size": 80,
           "collate_conf": {"feature_extraction_conf": {"mel_bins": 80},
                            "normalization": True}}
    path = os.path.join(WORK, f"stream_{compute_dtype}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def manifest_wavs(manifest: str) -> dict:
    """{key: x32768-scaled samples} of a manifest's wavs."""
    out = {}
    with open(manifest, encoding="utf-8") as f:
        for line in f:
            fields = dict(x.split(":", 1) for x in line.rstrip("\n")
                          .split("\t"))
            out[fields["utt"]] = read_wav(fields["feat"])[0] * 32768.0
    return out


def stream_wav(model, wav: np.ndarray, piece_ms: int = PIECE_MS,
               **kw) -> StreamingRecognizer:
    """One stream through StreamingRecognizer in piece_ms pieces, then
    finish()."""
    sr = StreamingRecognizer(model, chunk_size=CHUNK,
                             num_left_chunks=LEFT_CHUNKS, **kw)
    n = 16 * piece_ms
    for i in range(0, len(wav), n):
        sr.accept_waveform(wav[i:i + n])
    sr.finish()
    return sr


def _within(got: torch.Tensor, ref: torch.Tensor, rtol: float,
            atol: float) -> tuple[bool, float]:
    err = (got.float() - ref.float()).abs()
    return bool((err <= atol + rtol * ref.float().abs()).all()), \
        float(err.max())


def _frame_agreement(lp_ref: torch.Tensor, lp_got: torch.Tensor) -> dict:
    """Frame argmax of lp_got [T, V] against lp_ref on the frames whose
    top-2 margin in lp_ref exceeds 10 x the largest |lp_got - lp_ref|
    (the others are near-ties that rounding may flip)."""
    gap = float((lp_got - lp_ref).abs().max())
    top2 = lp_ref.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 10 * gap
    agree = lp_got.argmax(-1) == lp_ref.argmax(-1)
    return {"frames": int(lp_ref.shape[0]), "near_ties": int((~sure).sum()),
            "disagreements": int((sure & ~agree).sum()), "lp_gap": gap}


class K3Trace:
    """Records (shape, dtype, route) of each depthwise_conv1d call that
    the conv modules make, by wrapping the name they call; the wrapper's
    own launch count is untouched."""

    def __init__(self):
        self.calls: list[tuple] = []
        self._orig = conv_module.depthwise_conv1d

    def __enter__(self):
        def traced(x, w):
            route = dw.device_plan(x, w.shape[0], dgrad=False).route
            self.calls.append((tuple(x.shape), str(x.dtype).split(".")[-1],
                               route))
            return self._orig(x, w)
        conv_module.depthwise_conv1d = traced
        return self

    def __exit__(self, *exc):
        conv_module.depthwise_conv1d = self._orig


def stream_checks(cfg_path: str, ckpt: str, manifest: str) -> dict:
    """The streaming path on the card, float32, full width, seeded random
    weights, c = 16 with 4 left chunks, 200 ms pieces:
    - for 4 of the decode wavs, the encoder rows StreamingRecognizer
      collects match the offline chunk-masked encode of the same model
      on the card (host fbank of the whole wav) within rtol 1e-3 / atol
      2e-4, and the streamed greedy result is the offline greedy result
      (frame argmax equal wherever the top-2 margin exceeds 10 x the
      measured log-prob gap; tokens equal when no frame is that close);
      K3 runs 12 times per chunk step, at [1, 30, 256] float32, by TMA;
    - one stream's encoder rows on the card against the CPU (plain
      kernels) within ENC_TOL;
    - StreamingBatch at S = 8 over all 16 wavs, ragged (two piece sizes,
      16 streams through 8 slots, so slots are reused), against 16
      sequential S = 1 runs: the same frame-argmax rule and tokens,
      encoder rows within rtol 1e-3 / atol 2e-4, 12 K3 launches a step."""
    cfg = json.load(open(cfg_path))
    gpu = recognize.load_model(cfg, ckpt, VOCAB, torch.device("cuda"))
    cpu = recognize.load_model(cfg, ckpt, VOCAB, torch.device("cpu"))
    wavs = manifest_wavs(manifest)
    keys = sorted(wavs)
    rtol, atol = STREAM_TOL
    # K3's input on the chunk step: the conv cache, then the chunk
    chunk_shape = (1, gpu.cnn_module_kernel - 1 + CHUNK, gpu.d_model)
    out = {"streamed_vs_offline": []}
    with torch.inference_mode():
        for key in keys[:4]:
            wav = wavs[key]
            dw.depthwise_conv1d.launches = 0
            with K3Trace() as trace:
                sr = stream_wav(gpu, wav, collect_encoder_out=True)
            launches = dw.depthwise_conv1d.launches
            steps = sr.offset // CHUNK
            streamed = torch.from_numpy(np.concatenate(sr.enc_chunks)).cuda()
            t = streamed.shape[0]
            feats, flens = fbank_mod.fbank(
                torch.from_numpy(wav.astype(np.float32))[None],
                torch.tensor([len(wav)]))
            enc, lens = gpu.encode(feats.cuda(), flens.cuda())
            ok, err = _within(streamed, enc[0, :t], rtol, atol)
            lp_ref = gpu.ctc_log_probs(enc[:, :t])[0]
            agree = _frame_agreement(lp_ref, gpu.ctc_log_probs(
                streamed[None])[0])
            hyp, hyp_len = ctc_greedy_search(lp_ref[None],
                                             torch.tensor([t]).cuda())
            offline = hyp[0, :hyp_len[0]].tolist()
            row = {"key": key, "seconds": len(wav) / 16000, "rows": t,
                   "offline_rows": int(lens[0]), "chunk_steps": steps,
                   "k3_launches": launches,
                   "k3_shapes": sorted({c[:2] for c in trace.calls}),
                   "k3_routes": sorted({c[2] for c in trace.calls}),
                   "max_abs_err": err, "within_tol": ok,
                   "tokens": len(sr.result()),
                   "tokens_equal": sr.result() == offline, **agree}
            out["streamed_vs_offline"].append(row)
            print("stream_vs_offline " + json.dumps(row), flush=True)
            if not ok or t != int(lens[0]) or agree["disagreements"] \
                    or (not agree["near_ties"] and not row["tokens_equal"]):
                raise AssertionError(f"streamed encoder differs from the "
                                     f"offline chunk-masked one: {row}")
            if launches != 12 * steps or len(trace.calls) != launches \
                    or row["k3_routes"] != ["tma"] \
                    or row["k3_shapes"] != [(chunk_shape, "float32")]:
                raise AssertionError(f"K3 on the chunk step: {row}")

        wav = wavs[keys[0]]
        g = stream_wav(gpu, wav, collect_encoder_out=True)
        c = stream_wav(cpu, wav, collect_encoder_out=True)
        err = float(np.abs(np.concatenate(g.enc_chunks)
                           - np.concatenate(c.enc_chunks)).max())
        out["gpu_vs_cpu"] = {"key": keys[0], "max_abs_err": err,
                             "tokens_equal": g.result() == c.result()}
        if err > ENC_TOL:
            raise AssertionError(f"stream GPU vs CPU: {out['gpu_vs_cpu']}")

        seq = {}
        for key in keys:
            sr = stream_wav(gpu, wavs[key], collect_encoder_out=True)
            seq[key] = (sr.result(), np.concatenate(sr.enc_chunks))
        batch = StreamingBatch(gpu, slots=8, chunk_size=CHUNK,
                               num_left_chunks=LEFT_CHUNKS, beam_size=BEAM,
                               max_hyp_len=MAX_HYP_LEN)
        n_steps = [0]
        step = batch._step

        def counted(*args):
            n_steps[0] += 1
            return step(*args)

        batch._step = counted
        dw.depthwise_conv1d.launches = 0
        pending, live, got, slots_used = list(keys), [], {}, {}
        while pending or live:
            while pending and len(live) < 8:
                key = pending.pop(0)
                h = batch.open()
                slots_used.setdefault(h.slot, []).append(key)
                live.append([h, key, 0, 16 * (200 if h.slot % 2 else 130)])
            for ent in live:
                h, key, pos, n = ent
                batch.accept(h, wavs[key][pos:pos + n])
                ent[2] = pos + n
            batch.run_ready()
            still = []
            for ent in live:
                h, key, pos, _ = ent
                if pos < len(wavs[key]):
                    still.append(ent)
                    continue
                got[key] = (batch.finish(h, rescore=False),
                            batch.encoder_out(h))
                batch.close(h)
            live = still
        rows = []
        for key in keys:
            ref_toks, ref_enc = seq[key]
            toks, enc = got[key]
            ok, err = _within(torch.from_numpy(enc), torch.from_numpy(ref_enc),
                              rtol, atol)
            agree = _frame_agreement(
                gpu.ctc_log_probs(torch.from_numpy(ref_enc).cuda()[None])[0],
                gpu.ctc_log_probs(torch.from_numpy(enc).cuda()[None])[0])
            rows.append({"key": key, "tokens_equal": toks == ref_toks,
                         "rows_equal_count": enc.shape == ref_enc.shape,
                         "max_abs_err": err, "within_tol": ok, **agree})
        out["batch_vs_sequential"] = {
            "slots": 8, "streams": len(keys), "steps": n_steps[0],
            "k3_launches": dw.depthwise_conv1d.launches,
            "slots_reused": sum(len(v) > 1 for v in slots_used.values()),
            "streams_tokens_equal": sum(r["tokens_equal"] for r in rows),
            "near_tie_frames": sum(r["near_ties"] for r in rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows)}
        print("stream_batch " + json.dumps(out["batch_vs_sequential"]),
              flush=True)
        bad = [r for r in rows
               if not (r["within_tol"] and r["rows_equal_count"])
               or r["disagreements"]
               or (not r["near_ties"] and not r["tokens_equal"])]
        res = out["batch_vs_sequential"]
        if bad or res["k3_launches"] != 12 * res["steps"] \
                or not res["slots_reused"]:
            raise AssertionError(f"S = 8 batch vs sequential: {res} {bad}")
        out["batch_rows"] = rows
    return out


def stream_cli_runs(cfg32: str, cfg16: str, ckpt: str, manifest: str,
                    dict_path: str, t_enc: dict) -> list:
    """bin/stream_recognize on cuda over the 16 decode wavs, with
    --timestamp_file: --slots 1 greedy (piece latencies) and --slots 8
    attention_rescoring (aggregate x-realtime), in float32 and in
    bfloat16. K3's count is set to 0 before each run and read after;
    every key is written, the timestamps are sane, K3 ran 12 times per
    chunk step (S = 1: one step per 16 encoder positions, each stream's
    last one short)."""
    keys = {f"utt{i:03d}" for i in range(N_UTTS)}
    s1_steps = sum(math.ceil(t / CHUNK) for t in t_enc.values())
    runs = []
    for tag, cfg, extra in (
            ("stream_s1_greedy", cfg32,
             ["--slots", "1", "--final_mode", "ctc_greedy_search"]),
            ("stream_s8_rescoring", cfg32,
             ["--slots", "8", "--final_mode", "attention_rescoring",
              "--reverse_weight", "0.3", "--beam_size", str(BEAM)]),
            ("stream_s1_greedy_bf16", cfg16,
             ["--slots", "1", "--final_mode", "ctc_greedy_search"]),
            ("stream_s8_rescoring_bf16", cfg16,
             ["--slots", "8", "--final_mode", "attention_rescoring",
              "--reverse_weight", "0.3", "--beam_size", str(BEAM)])):
        out = os.path.join(WORK, f"hyp_{tag}.txt")
        ts = os.path.join(WORK, f"ts_{tag}.jsonl")
        dw.depthwise_conv1d.launches = 0
        stats = stream_recognize.main(
            ["--config", cfg, "--checkpoint", ckpt, "--test_data", manifest,
             "--dict", dict_path, "--result_file", out, "--timestamp_file",
             ts, "--device", "cuda", *extra])
        launches = dw.depthwise_conv1d.launches
        with open(out, encoding="utf-8") as f:
            hyps = dict((line.rstrip("\n").split(" ", 1) + [""])[:2]
                        for line in f)
        with open(ts, encoding="utf-8") as f:
            rows = [json.loads(line) for line in f]
        steps = launches // 12
        run = {"run": tag, "k3_launches": launches, "chunk_steps": steps,
               "s_per_chunk_step": stats["wall_s"] / max(steps, 1),
               "rtf": stats["wall_s"] / stats["audio_s"], **stats,
               "timestamps": check_timestamps(tag, rows, hyps, t_enc),
               "nonempty_hyps": sum(bool(v) for v in hyps.values())}
        runs.append(run)
        print("stream_cli " + json.dumps(run), flush=True)
        if set(hyps) != keys or launches % 12 \
                or ("_s1_" in tag and steps != s1_steps):
            raise AssertionError(f"{tag}: keys {sorted(hyps)}, K3 "
                                 f"{launches}, expected 12 x {s1_steps} "
                                 f"steps at S = 1")
    return runs


def stream_idle(cfg_path: str, ckpt: str, manifest: str) -> dict:
    """The device's idle share over profiled chunk steps (torch.profiler):
    one 200 ms-piece S = 1 stream of the longest wav, and one S = 8 batch
    of 8 wavs whose audio is all in before its steps run; host clock
    around each, synchronized."""
    from torch.profiler import ProfilerActivity, profile
    model = recognize.load_model(json.load(open(cfg_path)), ckpt, VOCAB,
                                 torch.device("cuda"))
    wavs = manifest_wavs(manifest)
    keys = sorted(wavs, key=lambda k: -len(wavs[k]))
    out = {}

    def s1():
        return stream_wav(model, wavs[keys[0]]).offset // CHUNK

    def s8():
        batch = StreamingBatch(model, slots=8, chunk_size=CHUNK,
                               num_left_chunks=LEFT_CHUNKS, beam_size=BEAM,
                               max_hyp_len=MAX_HYP_LEN)
        hs = [batch.open() for _ in range(8)]
        for h, key in zip(hs, keys[:8]):
            batch.accept(h, wavs[key])
        batch.run_ready()
        return int(batch._offset_host.max()) // CHUNK

    with torch.inference_mode():
        for name, fn in (("s1", s1), ("s8", s8)):
            fn()   # warm-up
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                steps = fn()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            busy = _device_busy_us(prof)
            host_ops = sum(1 for e in prof.events() if e.cpu_parent is None
                           and e.name.startswith("aten::"))
            out[name] = {"chunk_steps": steps,
                         "profiled_wall_s": wall_us / 1e6,
                         "s_per_chunk_step": wall_us / 1e6 / steps,
                         "host_ops_per_chunk_step": host_ops / steps,
                         "device_busy_s": busy / 1e6,
                         "device_idle_share": (1.0 - busy / wall_us
                                               if busy else None)}
        # the S = 8 step's two halves, host clock around synchronized
        # work: encode_chunk with the CTC head, and the c prefix-beam
        # frames the step carries
        s, dev = 8, next(model.parameters()).device
        k, v, cnn = zero_caches(model, s, LEFT_CHUNKS * CHUNK, dev)
        win = torch.randn((s, 4 * CHUNK + 3, 80), device=dev)
        offset = torch.zeros((s,), dtype=torch.long, device=dev)
        valid = torch.full((s,), CHUNK, device=dev)
        lp = torch.randn((s, CHUNK, VOCAB), device=dev).log_softmax(-1)

        def encode():
            enc = model.encode_chunk(win, offset, k, v, offset, cnn, valid)[0]
            model.ctc_log_probs(enc).argmax(-1)

        def beam():
            st = prefix_beam_init(s, BEAM, MAX_HYP_LEN, dev, True)
            for i in range(CHUNK):
                prefix_beam_step(st, lp[:, i], valid > i, 0, offset + i)

        for name, fn in (("encode_s", encode), ("beam_s", beam)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            out["s8"][name + "_per_chunk_step"] = \
                (time.perf_counter() - t0) / 5
    return out


def stream_training(train_data: str, cv_data: str, dict_path: str) -> dict:
    """bin.train on cuda with the streaming config (causal,
    use_dynamic_chunk, bf16) for one epoch; finite losses and the launch
    counts of check_train_counts; then bin/stream_recognize --slots 4 of
    the cv set from epoch_1.pt (no quality threshold)."""
    cfg_path = os.path.join(WORK, "train_conformer_streaming.json")
    with open(cfg_path, "w") as f:
        json.dump(STREAM_TRAIN_CONFIG, f)
    exp = os.path.join(WORK, "exp_stream")
    n_cv = len(AudioDataset(cv_data, load_dict(dict_path),
                            batch_type="dynamic", max_frames_in_batch=10000))
    _reset_counts()
    t0 = time.perf_counter()
    state = train_cli.main(["--config", cfg_path, "--train_data", train_data,
                            "--cv_data", cv_data, "--dict", dict_path,
                            "--exp_dir", exp, "--device", "cuda",
                            "--num_workers", "4"])
    torch.cuda.synchronize()
    counts = _counts()
    out = {"train_wall_s": time.perf_counter() - t0, "steps": state.step,
           "launches": counts}
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    out["step_losses"] = [r["loss"] for r in records if r["kind"] == "train"]
    out["cv"] = [r for r in records if r["kind"] == "epoch"]
    if len(out["step_losses"]) != state.step or not all(
            math.isfinite(x) for x in out["step_losses"]):
        raise AssertionError(f"streaming training losses: {records}")
    check_train_counts({"n_train_steps": state.step, "n_cv_batches": n_cv},
                       counts, decode_batches=0)
    hyp = os.path.join(WORK, "hyp_stream_trained.txt")
    dw.depthwise_conv1d.launches = 0
    stats = stream_recognize.main([
        "--config", os.path.join(exp, "train.json"), "--checkpoint",
        os.path.join(exp, "epoch_1.pt"), "--test_data", cv_data, "--dict",
        dict_path, "--result_file", hyp, "--slots", "4", "--device", "cuda"])
    with open(hyp, encoding="utf-8") as f:
        out["decoded"] = sum(1 for _ in f)
    out["decode"] = dict(stats, k3_launches=dw.depthwise_conv1d.launches)
    if out["decoded"] != N_CV:
        raise AssertionError(f"stream_recognize wrote {out['decoded']} lines")
    return out


# ---------------------------------------------------------------- serving

SERVE_SLOTS = 8
ENDPOINT_RULE3_MS = 2000.0


def build_served(cfg_path: str, ckpt: str, dict_path: str, *extra):
    """An AsrServer through bin/serve's build_server on cuda, 127.0.0.1,
    port 0, --slots 8, rescoring finals, reverse_weight 0.3."""
    return serve_cli.build_server(serve_cli.get_parser().parse_args(
        ["--config", cfg_path, "--checkpoint", ckpt, "--dict", dict_path,
         "--port", "0", "--slots", str(SERVE_SLOTS), "--chunk_size",
         str(CHUNK), "--num_left_chunks", str(LEFT_CHUNKS), "--beam_size",
         str(BEAM), "--max_hyp_len", str(MAX_HYP_LEN), "--reverse_weight",
         "0.3", "--device", "cuda", *extra]))


def client_session(addr, wav: np.ndarray, rate: int = 16000,
                   pace: bool = False, send_end: bool = True) -> dict:
    """One AsrClient session: `wav` (x32768 floats at `rate`) in
    PIECE_MS pieces, as fast as the socket takes them (at the audio's
    own pace when `pace`), then "end" (unless not `send_end`: then it
    waits for the server's endpoint final and stops sending when it
    arrives). A reader thread stamps each event on the host clock."""
    c = AsrClient(*addr, sample_rate=rate, timeout=300)
    out = {"partials": [], "t_partials": [], "errors": [], "final": None,
           "sent_s": 0.0}

    def reader():
        try:
            while True:
                frame = recv_frame(c.sock)
                if frame is None:
                    return
                t, ev = time.perf_counter(), json.loads(frame[1])
                if ev["event"] == "partial":
                    out["partials"].append(ev)
                    out["t_partials"].append(t)
                elif ev["event"] == "error":
                    out["errors"].append(ev)
                    return
                elif ev["event"] == "final":
                    out["final"], out["t_final"] = ev, t
                    return
        except OSError as e:
            out["errors"].append({"message": repr(e)})

    th = threading.Thread(target=reader, daemon=True)
    try:
        out["t_open"] = t0 = time.perf_counter()
        th.start()
        n = rate * PIECE_MS // 1000
        for i in range(0, len(wav), n):
            if pace:
                time.sleep(max(0.0, t0 + i / rate - time.perf_counter()))
            if out["final"] is not None:
                break
            c.send_audio(wav[i:i + n])
            out["sent_s"] = min(i + n, len(wav)) / rate
        out["t_end"] = time.perf_counter()
        if send_end:
            send_json(c.sock, {"op": "end"})
        th.join(timeout=300)
    finally:
        c.close()
    if th.is_alive() or out["errors"] or out["final"] is None:
        raise AssertionError(f"serve session: {out['errors']}, final "
                             f"{out['final']}")
    return out


def serve_traffic(srv, wavs: list, wav8k=None) -> dict:
    """Every wav as a concurrent client session (a thread each), plus
    one at 8 kHz; K3's count set to 0 just before and read just after;
    the server's chunk steps counted and K3's shapes traced."""
    n_steps = [0]
    step = srv.batch._step

    def counted(*args):
        n_steps[0] += 1
        return step(*args)

    srv.batch._step = counted
    jobs = [(w, 16000) for w in wavs]
    if wav8k is not None:
        jobs.append((wav8k, 8000))
    sessions = [None] * len(jobs)
    failures = []

    def run(i):
        try:
            sessions[i] = client_session(srv.addr, *jobs[i])
        except (AssertionError, OSError) as e:
            failures.append(repr(e))

    dw.depthwise_conv1d.launches = 0
    with K3Trace() as trace:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(jobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
    launches = dw.depthwise_conv1d.launches
    srv.batch._step = step
    if failures or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve traffic: {failures}")
    t0 = min(s["t_open"] for s in sessions)
    t1 = max(s["t_final"] for s in sessions)
    audio_s = sum(s["final"]["audio_s"] for s in sessions)
    end_to_final = [s["t_final"] - s["t_end"] for s in sessions]
    first_partial = [s["t_partials"][0] - s["t_open"] for s in sessions
                     if s["t_partials"]]
    shapes = Counter(c[:2] for c in trace.calls)
    routes = Counter(c[2] for c in trace.calls)
    res = {"sessions": len(sessions), "audio_s": audio_s, "wall_s": t1 - t0,
           "x_realtime": audio_s / (t1 - t0), "chunk_steps": n_steps[0],
           "k3_launches": launches,
           "k3_shapes": {f"{list(k[0])} {k[1]}": v for k, v in shapes.items()},
           "k3_routes": dict(routes),
           "end_to_final_ms_p50": float(np.percentile(end_to_final, 50) * 1e3),
           "end_to_final_ms_p99": float(np.percentile(end_to_final, 99) * 1e3),
           "first_partial_ms_p50": (float(np.percentile(first_partial, 50)
                                          * 1e3) if first_partial else None),
           "sessions_with_partials": len(first_partial)}
    if launches != 12 * n_steps[0] or not launches \
            or sum(shapes.values()) != launches or set(routes) != {"tma"} \
            or set(shapes) != {((SERVE_SLOTS, 14 + CHUNK,
                                 srv.batch.model.d_model), "float32")}:
        raise AssertionError(f"K3 while serving: {res}")
    return {"stats": res, "sessions": sessions}


def _pcm(wav: np.ndarray) -> np.ndarray:
    """The samples as AsrClient sends them: rounded to int16."""
    return np.clip(np.round(wav), -32768, 32767).astype(np.int16)


def direct_finals(model, wavs: list, wav8k=None) -> list:
    """What the server must answer: each wav (as int16, the 8 kHz one
    resampled piece by piece as the server does) through a float16
    StreamingBatch with the server's settings, 8 at a time; per stream
    (final tokens, times_ms, full-chunk greedy path before finish, the
    smallest top-2 CTC log-prob margin of its frames)."""
    streams = [[_pcm(w).astype(np.float32)] for w in wavs]
    if wav8k is not None:
        pcm, n = _pcm(wav8k), 8000 * PIECE_MS // 1000
        streams.append([resample(pcm[i:i + n].astype(np.float32), 8000,
                                 16000) for i in range(0, len(pcm), n)])
    batch = StreamingBatch(model, slots=SERVE_SLOTS, chunk_size=CHUNK,
                           num_left_chunks=LEFT_CHUNKS, beam_size=BEAM,
                           max_hyp_len=MAX_HYP_LEN, normalization="running",
                           transfer_dtype="float16")
    out = []
    for g in range(0, len(streams), SERVE_SLOTS):
        group = streams[g:g + SERVE_SLOTS]
        hs = [batch.open() for _ in group]
        for h, pieces in zip(hs, group):
            for p in pieces:
                batch.accept(h, p)
        batch.run_ready()
        greedy = [h.result() for h in hs]
        finals = batch.finish_many(hs, rescore=True, ctc_weight=0.5,
                                   reverse_weight=0.3)
        for h, gr in zip(hs, greedy):
            with torch.inference_mode():
                lp = model.ctc_log_probs(torch.from_numpy(
                    batch.encoder_out(h)).cuda())
            top2 = lp.topk(2, dim=-1).values
            out.append((finals[h.slot], h.result_times_ms(), gr,
                        float((top2[:, 0] - top2[:, 1]).min())))
            batch.close(h)
    return out


def serve_checks(cfg_path: str, ckpt: str, manifest: str,
                 dict_path: str) -> dict:
    """bin/serve on the card, float32, the streaming Conformer: 16
    clients sending the decode wavs in 200 ms pieces as fast as the
    socket takes them (8 wait for admission) and one at 8 kHz. Every
    final equals the direct float16 StreamingBatch's tokens and times;
    the partials of each session concatenate to a prefix of its direct
    greedy path; no error event. x-realtime, end-to-final and
    first-partial latency, K3 launches; then the same 16 clients again
    under torch.profiler for the idle share over the serving window."""
    from torch.profiler import ProfilerActivity, profile
    wavs = manifest_wavs(manifest)
    keys = sorted(wavs)
    wav8k = resample(wavs[keys[0]], 16000, 8000)
    srv = build_served(cfg_path, ckpt, dict_path)
    srv.start()
    try:
        run = serve_traffic(srv, [wavs[k] for k in keys], wav8k)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prof_run = serve_traffic(srv, [wavs[k] for k in keys])
    finally:
        srv.shutdown()
    busy = _device_busy_us(prof)
    wall = prof_run["stats"]["wall_s"]
    direct = direct_finals(srv.batch.model, [wavs[k] for k in keys], wav8k)
    rows = []
    for key, s, (toks, times, greedy, margin) in zip(
            keys + ["8khz"], run["sessions"], direct):
        streamed = [t for p in s["partials"] for t in p["tokens"]]
        rows.append({"key": key, "tokens": len(toks),
                     "final_equal": (s["final"]["tokens"] == toks
                                     and s["final"]["times_ms"] == times),
                     "partials_prefix": streamed == greedy[:len(streamed)],
                     "partial_tokens": len(streamed),
                     "min_logp_margin": margin})
    out = dict(run["stats"], profiled_wall_s=wall,
               profiled_x_realtime=prof_run["stats"]["x_realtime"],
               device_busy_s=busy / 1e6,
               device_idle_share=1.0 - busy / 1e6 / wall if busy else None,
               finals_equal=sum(r["final_equal"] for r in rows),
               min_logp_margin=min(r["min_logp_margin"] for r in rows),
               profiled_k3_launches=prof_run["stats"]["k3_launches"])
    out["finals"] = {k: s["final"]["tokens"]
                     for k, s in zip(keys, run["sessions"])}
    print("serve " + json.dumps({k: v for k, v in out.items()
                                 if k != "finals"}), flush=True)
    bad = [r for r in rows if not (r["final_equal"] and r["partials_prefix"])]
    if bad or not out["sessions_with_partials"]:
        raise AssertionError(f"server vs direct StreamingBatch: {bad}")
    out["rows"] = rows
    return out


def serve_endpoint(cfg_path: str, ckpt: str, manifest: str,
                   dict_path: str) -> dict:
    """One session on bin/serve --endpoint --endpoint_rule3_ms 2000, the
    longest decode wav sent at its own pace and no "end": the final must
    come with "endpoint": true once at most 2000 ms plus one chunk
    (640 ms) of audio is decoded (read when the server calls finish),
    before the wav is all sent."""
    wavs = manifest_wavs(manifest)
    wav = max(wavs.values(), key=len)
    srv = build_served(cfg_path, ckpt, dict_path, "--endpoint",
                       "--endpoint_rule3_ms", str(ENDPOINT_RULE3_MS))
    decoded_ms = []
    finish = srv.batch.finish

    def noted(handle, **kw):
        decoded_ms.append(int(srv.batch._offset_host[handle.slot])
                          * FRAME_MS)
        return finish(handle, **kw)

    srv.batch.finish = noted
    srv.start()
    try:
        s = client_session(srv.addr, wav, pace=True, send_end=False)
    finally:
        srv.shutdown()
    out = {"wav_s": len(wav) / 16000, "sent_s": s["sent_s"],
           "final_audio_s": s["final"]["audio_s"],
           "endpoint": s["final"]["endpoint"], "decoded_ms": decoded_ms,
           "tokens": len(s["final"]["tokens"]),
           "open_to_final_s": s["t_final"] - s["t_open"]}
    print("serve_endpoint " + json.dumps(out), flush=True)
    if out["endpoint"] is not True or len(decoded_ms) != 1 \
            or decoded_ms[0] > ENDPOINT_RULE3_MS + CHUNK * FRAME_MS \
            or out["sent_s"] >= out["wav_s"]:
        raise AssertionError(f"endpoint final: {out}")
    return out


def int8_checks(cfg_s32: str, ckpt_s: str, cfg32: str, ckpt: str,
                manifest: str, dict_path: str, f32_finals: dict) -> dict:
    """--quantize int8 on the card: bin/serve with the same 16 clients
    (x-realtime; how many finals equal the float32 server's, reported
    only: random weights decide nothing about quality) and
    bin/recognize on the flagship, attention_rescoring, batch 8 (RTF,
    agreement with the float32 run, reported only). The widened weights
    on the card are bit-equal to the CPU's; on 4 wavs the int8 greedy
    tokens on the card equal the CPU's."""
    out = {}
    cfg = json.load(open(cfg32))
    gpu = recognize.load_model(cfg, ckpt, VOCAB, torch.device("cuda"), "int8")
    cpu = recognize.load_model(cfg, ckpt, VOCAB, torch.device("cpu"), "int8")
    now, fp32 = quantized_bytes(gpu)
    out["weight_mb"], out["ratio_vs_fp32"] = now / 1e6, fp32 / now
    print(f"int8 weight quantization: {now / 1e6:.1f} MB "
          f"({fp32 / now:.2f}x vs fp32)", flush=True)
    cpu_modules = dict(cpu.named_modules())
    n_q = 0
    with torch.inference_mode():
        for name, m in gpu.named_modules():
            if isinstance(m, Dense) and m.q is not None:
                n_q += 1
                if not torch.equal(m.dense_weight().cpu(),
                                   cpu_modules[name].dense_weight()):
                    raise AssertionError(f"int8 {name}: card != CPU")
    out["dense_int8"] = n_q
    del gpu, cpu

    wavs = manifest_wavs(manifest)
    keys = sorted(wavs)
    srv = build_served(cfg_s32, ckpt_s, dict_path, "--quantize", "int8")
    srv.start()
    try:
        run = serve_traffic(srv, [wavs[k] for k in keys])
    finally:
        srv.shutdown()
    out["serve"] = dict(run["stats"], finals_equal_f32=sum(
        s["final"]["tokens"] == f32_finals[k]
        for k, s in zip(keys, run["sessions"])))

    hyps, wall, launches, _ = run_recognize(
        cfg32, ckpt, manifest, dict_path, "attention_rescoring", "int8",
        ["--quantize", "int8"])
    with open(os.path.join(WORK, "hyp_attention_rescoring.txt"),
              encoding="utf-8") as f:
        f32 = dict((line.rstrip("\n").split(" ", 1) + [""])[:2] for line in f)
    audio_s = sum(len(w) for w in wavs.values()) / 16000
    out["recognize"] = {"wall_s": wall, "rtf": wall / audio_s,
                        "k3_launches": launches,
                        "hyps_equal_f32": sum(hyps[k] == f32[k] for k in keys)}
    if set(hyps) != set(keys) or launches % 12 or not launches:
        raise AssertionError(f"recognize --quantize int8: {out['recognize']}")

    small = os.path.join(WORK, "format4.data")
    with open(manifest, encoding="utf-8") as f, \
            open(small, "w", encoding="utf-8") as g:
        g.writelines(f.readlines()[:4])
    got = {}
    for dev in ("cuda", "cpu"):
        hyp = os.path.join(WORK, f"hyp_int8_{dev}.txt")
        recognize.main(["--config", cfg32, "--checkpoint", ckpt, "--test_data",
                        small, "--dict", dict_path, "--result_file", hyp,
                        "--mode", "ctc_greedy_search", "--batch_size", "4",
                        "--quantize", "int8", "--device", dev])
        with open(hyp, encoding="utf-8") as f:
            got[dev] = dict((line.rstrip("\n").split(" ", 1) + [""])[:2]
                            for line in f)
    out["greedy_gpu_equals_cpu"] = sum(got["cuda"][k] == got["cpu"][k]
                                       for k in got["cpu"])
    print("int8 " + json.dumps(out), flush=True)
    if len(got["cpu"]) != 4 or out["greedy_gpu_equals_cpu"] != 4:
        raise AssertionError(f"int8 greedy tokens, card vs CPU: {got}")
    return out


# ---------------------------------------------------------------- timing 2

def event_ms(fn, reps: int = 5) -> float:
    """Mean time per call from CUDA events around `reps` calls launched
    from the host (for calls that cannot be captured in a graph, or whose
    launch cost is part of what is compared)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def _n_copies(nbytes: int) -> int:
    return max(2, min(64, math.ceil(2 * L2_BYTES / nbytes)))


# ---------------------------------------------------------- K3 backward

def dwconv_grad_case(b: int, tp: int, c: int, k: int, dtype, gen,
                     offset: bool = False) -> dict:
    """K3 dgrad and wgrad against their plain versions; times them, unless
    `offset` (x and dy at a 2-byte offset, checked only)."""
    dev = torch.device("cuda")
    t = tp - k + 1
    x = torch.randn((b, tp, c), generator=gen, device=dev).to(dtype)
    dy = torch.randn((b, t, c), generator=gen, device=dev).to(dtype)
    w = (torch.randn((k, c), generator=gen, device=dev) * 0.3).to(dtype)
    if offset:
        x, dy = offset_view(x), offset_view(dy)
    name = str(dtype).split(".")[-1]
    dx = dw.depthwise_conv1d_dgrad(dy, w)
    dx_plain = dw.depthwise_conv1d_dgrad_plain(dy, w)
    dwk = dw.depthwise_conv1d_wgrad(x, dy)
    dw_plain = dw.depthwise_conv1d_wgrad_plain(x, dy)
    torch.cuda.synchronize()
    dgrad_err = float((dx.float() - dx_plain.float()).abs().max())
    w_ref = dw.depthwise_conv1d_wgrad_plain(x.float(), dy.float())
    wgrad_err = float((dwk.float() - w_ref).abs().max())
    row = {"shape": [b, tp, c], "k": k, "dtype": name,
           "dgrad_route": dw.device_plan(dy, k, dgrad=True).route,
           "wgrad_route": dw.wgrad_plan(
               b, tp, c, k, x.element_size(), x_ptr=x.data_ptr() % 16,
               dy_ptr=dy.data_ptr() % 16).route,
           "offset_bytes": x.data_ptr() % 16,
           "dgrad_max_abs_err": dgrad_err, "wgrad_max_abs_err": wgrad_err,
           "wgrad_rel_err": wgrad_err / float(w_ref.abs().max()),
           "wgrad_vs_plain_max_abs_err": float(
               (dwk.float() - dw_plain.float()).abs().max())}
    if not torch.equal(dw.depthwise_conv1d_wgrad(x, dy), dwk):
        raise AssertionError("wgrad differs between two runs")
    if dtype == torch.float32:
        ok = dgrad_err == 0.0 and row["wgrad_rel_err"] <= 1e-5
    else:
        ulp_dx = bf16_ulp(dw.depthwise_conv1d_dgrad_plain(dy.float(),
                                                          w.float()))
        row["dgrad_max_err_ulps"] = float(
            ((dx.float() - dx_plain.float()).abs() / ulp_dx).max())
        # bf16 dw is the kernel's float32 sum rounded once
        own = dw.depthwise_conv1d_wgrad(x.float(), dy.float())
        row["wgrad_max_err_ulps"] = float(
            ((dwk.float() - own).abs() / bf16_ulp(own)).max())
        row["wgrad_max_err_ulps_vs_plain"] = float(
            ((dwk.float() - w_ref).abs() / bf16_ulp(w_ref)).max())
        ok = row["dgrad_max_err_ulps"] <= 1.0 \
            and row["wgrad_max_err_ulps"] <= 1.0
    if not ok:
        raise AssertionError(f"K3 backward disagrees with its plain "
                             f"version: {row}")
    if offset:
        return row

    item = x.element_size()
    n = _n_copies((x.numel() + 2 * dy.numel()) * item)
    xs = [x.clone() for _ in range(n)]
    dys = [dy.clone() for _ in range(n)]
    x_ncw = [xi.transpose(1, 2).contiguous() for xi in xs]
    dy_ncw = [d.transpose(1, 2).contiguous() for d in dys]
    w_conv = w.t().contiguous()[:, None, :]

    def conv_bwd(i, mask):
        return torch.ops.aten.convolution_backward(
            dy_ncw[i], x_ncw[i], w_conv, None, [1], [0], [1], False, [0], c,
            mask)

    row["dgrad_ms"] = device_ms(
        lambda i: dw.depthwise_conv1d_dgrad(dys[i], w), n)
    row["dgrad_plain_ms"] = device_ms(
        lambda i: dw.depthwise_conv1d_dgrad_plain(dys[i], w), n)
    row["dgrad_library_ms"] = device_ms(
        lambda i: conv_bwd(i, [True, False, False]), n)
    row["wgrad_ms"] = device_ms(lambda i: dw.depthwise_conv1d_wgrad(
        xs[i], dys[i]), n)
    row["wgrad_plain_ms"] = device_ms(
        lambda i: dw.depthwise_conv1d_wgrad_plain(xs[i], dys[i]), n)
    row["wgrad_library_ms"] = device_ms(
        lambda i: conv_bwd(i, [False, True, False]), n)
    # dgrad: read dy and w, write dx; wgrad: read x and dy, write dw
    row["dgrad_bound_ms"], row["dgrad_bound_by"] = _bound(
        (dy.numel() + w.numel() + x.numel()) * item, 2 * b * tp * c * k)
    row["wgrad_bound_ms"], row["wgrad_bound_by"] = _bound(
        (x.numel() + dy.numel() + w.numel()) * item, 2 * b * t * c * k)
    return row


def _device_kernels(call, attempts: int = 3) -> dict:
    """Names of the device kernels one call runs (torch.profiler), after a
    warm-up call, and the number of traces taken: a trace with no device
    event at all is taken as the profiler missing the call, so it is taken
    again, up to `attempts` times."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    names: list[str] = []
    for traces in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return {"kernels": names, "traces": traces}


def k3_kernels_per_call(shapes: list[tuple], ctc_shapes: list[tuple],
                        gen) -> list[dict]:
    """torch.profiler over one call each of depthwise_conv1d,
    depthwise_conv1d_dgrad and depthwise_conv1d_wgrad at `shapes`, and of
    the CTC kernel dispatch_variant picks (ctc_dp_shared or ctc_dp_global)
    at each of `ctc_shapes` (B, T, L), its inputs already in the kernel's
    dtypes: each must run exactly one device kernel. Each row keeps the
    number of traces its call took (`traces`, in chip_smoke.json)."""
    dev = torch.device("cuda")
    rows = []
    for b, tp, c, k, dtype in shapes:
        x = torch.randn((b, tp, c), generator=gen, device=dev).to(dtype)
        dy = torch.randn((b, tp - k + 1, c), generator=gen,
                         device=dev).to(dtype)
        w = torch.randn((k, c), generator=gen, device=dev).to(dtype)
        for name, call in (("depthwise_conv1d",
                            lambda: dw.depthwise_conv1d(x, w)),
                           ("depthwise_conv1d_dgrad",
                            lambda: dw.depthwise_conv1d_dgrad(dy, w)),
                           ("depthwise_conv1d_wgrad",
                            lambda: dw.depthwise_conv1d_wgrad(x, dy))):
            rows.append({"call": name, "shape": [b, tp, c], "k": k,
                         "dtype": str(dtype).split(".")[-1],
                         **_device_kernels(call)})
    for ctc_shape in ctc_shapes:
        p = ctc_problem(*ctc_shape, VOCAB, gen)
        z, s_lens = ctc.extended_labels(p["labels"], p["ll"])
        llp = ctc.gather_label_logp(p["log_probs"], z)
        il, sl = p["il"].int(), s_lens.int()
        a2 = ctc.transition_masks(z).to(torch.uint8)
        kernel = ctc.ctc_dp_shared \
            if ctc.dispatch_variant(*llp.shape) == "shared" \
            else ctc.ctc_dp_global
        rows.append({"call": kernel.__name__, "shape": list(llp.shape),
                     **_device_kernels(lambda: kernel(llp, il, sl, a2))})
    for row in rows:
        if len(row["kernels"]) != 1:
            raise AssertionError(f"one call ran {len(row['kernels'])} "
                                 f"device kernels: {row}")
    return rows


# ---------------------------------------------------------------- CTC

def check_global_plan() -> list:
    """K2's plan as the C launcher makes it (openeat_ctc_global_plan)
    against ctc.global_plan, at widths from 1 to MAX_S."""
    fn = ctc._entry("openeat_ctc_global_plan",
                    (ctypes.c_int, ctypes.c_void_p))
    out = (ctypes.c_int * 4)()
    plans = []
    for s in (1, 32, 33, 49, 64, 65, 128, 129, 241, 256, 257, 512, 513,
              1001, ctc.MAX_S):
        fn(s, ctypes.addressof(out))
        if tuple(out) != ctc.global_plan(s):
            raise AssertionError(f"K2 plan at S = {s}: C {tuple(out)}, "
                                 f"Python {ctc.global_plan(s)}")
        plans.append([s, *out])
    return plans


def ctc_problem(b: int, t: int, l_pad: int, v: int, gen) -> dict:
    """Log-probs [B, T, V] and labels [B, L] on the card with a repeated
    label, an infeasible row (more labels than frames), len == 1 and an
    input length of T + 5 (row 3, or row 0 where B <= 3), which the
    kernels and the plain version walk as T."""
    dev = torch.device("cuda")
    lp = torch.randn((b, t, v), generator=gen, device=dev).log_softmax(-1)
    labels = torch.randint(1, v, (b, l_pad), generator=gen, device=dev)
    labels[0, 1] = labels[0, 0]
    il = torch.randint(max(t // 2, 1), t + 1, (b,), generator=gen,
                       device=dev)
    ll = torch.randint(max(l_pad // 2, 1), l_pad + 1, (b,), generator=gen,
                       device=dev)
    il[0], ll[0] = t, l_pad
    if b > 1:
        il[1], ll[1] = 1, 1
    if b > 2:
        il[2], ll[2] = max(l_pad // 2 - 1, 1), l_pad
    il[3 if b > 3 else 0] = t + 5
    return {"log_probs": lp, "labels": labels, "il": il, "ll": ll}


def ctc_case(b: int, t: int, l_pad: int, v: int, gen,
             step_ms: float | None = None) -> dict:
    """The CTC kernel dispatch_variant picks at [B, T, S=2L+1] against
    the plain recursions, bit for bit (loss and gamma, NEG_INF entries
    included); times of the kernel alone, the plain version, the port's
    whole CTC op and F.ctc_loss (forward and backward). `step_ms`, one
    chain step's device time (ctc.chain_step_ms), gives the chain bound:
    T dependent steps, alpha and beta side by side."""
    p = ctc_problem(b, t, l_pad, v, gen)
    z, s_lens = ctc.extended_labels(p["labels"], p["ll"])
    allow2 = ctc.transition_masks(z)
    llp = ctc.gather_label_logp(p["log_probs"], z)
    s = llp.shape[2]
    variant = ctc.dispatch_variant(b, t, s)
    kernel = ctc.ctc_dp_shared if variant == "shared" else ctc.ctc_dp_global
    loss, gamma = kernel(llp, p["il"], s_lens, allow2)
    ref_loss, ref_gamma = ctc.ctc_dp_plain(llp, p["il"], s_lens, allow2)
    torch.cuda.synchronize()
    fin = ref_gamma > -1e29
    row = {"shape": [b, t, s], "v": v, "variant": variant,
           "loss_max_abs_err": float((loss - ref_loss).abs().max()),
           "gamma_max_abs_err": float((gamma - ref_gamma).abs().max()),
           "neg_inf_equal": bool(torch.equal(gamma <= -1e29, ~fin)),
           "infeasible_loss": float(loss[2]) if b > 2 else None}
    row["max_abs_err"] = max(row["loss_max_abs_err"],
                             row["gamma_max_abs_err"])
    if not (row["max_abs_err"] == 0.0 and row["neg_inf_equal"]):
        raise AssertionError(f"CTC kernel disagrees with its plain version: "
                             f"{row}")

    nbytes = 2 * llp.numel() * 4 + allow2.numel() + 3 * b * 4
    n = _n_copies(nbytes)
    llps = [llp.clone() for _ in range(n)]
    # the kernel alone: lengths already in its int32
    il32, sl32 = p["il"].int(), s_lens.int()
    row["ms"] = device_ms(lambda i: kernel(llps[i], il32, sl32, allow2), n)
    row["plain_ms"] = event_ms(lambda: ctc.ctc_dp_plain(
        llp, p["il"], s_lens, allow2), reps=2)
    # the bytes bound; the chain of dependent steps bounds the kernel
    row["bound_ms"], row["bound_by"] = _bound(nbytes, 20.0 * b * t * s)
    row["chain_bound_ms"] = t * step_ms if step_ms is not None else None

    lp = p["log_probs"].detach().requires_grad_()
    lp_tbv = p["log_probs"].transpose(0, 1).detach().requires_grad_()

    def port_op():
        per = ctc.ctc_loss(lp, p["il"], p["labels"], p["ll"])
        torch.autograd.grad(per.sum(), lp)

    il_t = p["il"].clamp(max=t)  # F.ctc_loss refuses lengths above T

    def library_op():
        loss = F.ctc_loss(lp_tbv, p["labels"], il_t, p["ll"], blank=0,
                          reduction="sum", zero_infinity=True)
        torch.autograd.grad(loss, lp_tbv)

    row["op_ms"] = event_ms(port_op)
    row["library_ms"] = event_ms(library_op)
    return row


# ---------------------------------------------------------- training

def write_wavs(rng: np.random.Generator, prefix: str, durations: list,
               n_tokens: list) -> str:
    """Synthetic wavs with random transcripts over the dict; returns the
    manifest path."""
    wav_dir = os.path.join(WORK, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    lines = []
    for i, (dur, n_tok) in enumerate(zip(durations, n_tokens)):
        t = np.arange(int(dur * 16000)) / 16000.0
        x = sum(0.1 * np.sin(2 * np.pi * rng.uniform(80, 3000) * t)
                for _ in range(3)) + 0.02 * rng.standard_normal(t.size)
        path = os.path.join(wav_dir, f"{prefix}{i:03d}.wav")
        write_wav(path, x.astype(np.float32), 16000)
        text = "".join(chr(0x4E00 + j)
                       for j in rng.integers(0, VOCAB - 3, n_tok))
        lines.append(f"utt:{prefix}{i:03d}\tfeat:{path}\t"
                     f"feat_shape:{dur:.3f}\ttext:{text}\n")
    manifest = os.path.join(WORK, f"{prefix}.data")
    with open(manifest, "w", encoding="utf-8") as f:
        f.writelines(lines)
    return manifest


def write_train_corpus(rng: np.random.Generator) -> tuple[str, str, float]:
    durs = [float(np.round(rng.uniform(3.0, 8.0), 3)) for _ in range(N_TRAIN)]
    toks = [int(round(3 * d)) for d in durs]
    train = write_wavs(rng, "tr", durs + [LONG_SECONDS] * 2,
                       toks + [LONG_TOKENS] * 2)
    cv_durs = [float(np.round(rng.uniform(3.0, 8.0), 3)) for _ in range(N_CV)]
    cv = write_wavs(rng, "cv", cv_durs, [int(round(3 * d)) for d in cv_durs])
    return train, cv, sum(durs) + 2 * LONG_SECONDS


def train_shapes(manifest: str, dict_path: str) -> list[tuple]:
    """(B, T', L) of every training batch: the trainer's dynamic batches,
    wavs padded to whole seconds, fbank frames, conv2d x4 subsampling,
    labels padded to a multiple of 8."""
    dc = TRAIN_CONFIG["dataset_conf"]
    ds = AudioDataset(manifest, load_dict(dict_path),
                      max_length=dc["max_length"],
                      min_length=dc["min_length"], batch_type="dynamic",
                      max_frames_in_batch=dc["max_frames_in_batch"])
    shapes = []
    for batch in ds.batches:
        samples = max(round(u.num_frames * 160) for u in batch)
        padded = math.ceil(samples / 16000) * 16000
        frames = (padded - 400) // 160 + 1
        t_enc = ((frames - 3) // 2 + 1 - 3) // 2 + 1
        l_pad = math.ceil(max(len(u.token_ids) for u in batch) / 8) * 8
        shapes.append((len(batch), t_enc, l_pad))
    return shapes


COUNTED = (dw.depthwise_conv1d, dw.depthwise_conv1d_dgrad,
           dw.depthwise_conv1d_wgrad, ctc.ctc_dp_shared, ctc.ctc_dp_global)


def _reset_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0


def _counts() -> dict:
    return {fn.__name__: fn.launches for fn in COUNTED}


def run_training(train_data: str, cv_data: str, dict_path: str) -> dict:
    """bin.train on cuda for 2 epochs, a resume from epoch_1.pt, and
    recognize from epoch_2.pt; checks and launch counts."""
    cfg_path = os.path.join(WORK, "train_conformer.json")
    with open(cfg_path, "w") as f:
        json.dump(TRAIN_CONFIG, f)
    exp = os.path.join(WORK, "exp")
    args = ["--config", cfg_path, "--train_data", train_data, "--cv_data",
            cv_data, "--dict", dict_path, "--exp_dir", exp, "--device",
            "cuda", "--num_workers", "4"]
    n_cv = len(AudioDataset(cv_data, load_dict(dict_path),
                            batch_type="dynamic",
                            max_frames_in_batch=10000))
    out = {}
    t0 = time.perf_counter()
    state = train_cli.main(args)
    torch.cuda.synchronize()
    out["train_wall_s"] = time.perf_counter() - t0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if r["kind"] == "train"]
    out["step_losses"] = losses
    out["epochs"] = [r for r in records if r["kind"] == "epoch"]
    if len(losses) != state.step or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training losses: {losses}")
    for name in ("epoch_1.pt", "epoch_1.json", "epoch_2.pt", "epoch_2.json",
                 "optimizer.pt", "train.json"):
        if not os.path.exists(os.path.join(exp, name)):
            raise AssertionError(f"training did not write {name}")
    steps_2 = state.step
    with open(os.path.join(exp, "epoch_1.json")) as f:
        steps_1 = json.load(f)["step"]
    # resume from epoch_1.pt for one epoch, into its own directory so that
    # epoch_2.pt stays for the decode below; optimizer.pt beside
    # epoch_1.pt is epoch 2's, so Adam starts afresh, as the JAX trainer
    # does in that case
    args_r = args[:args.index("--exp_dir")] + [
        "--exp_dir", os.path.join(WORK, "exp_resume")] + args[
        args.index("--exp_dir") + 2:]
    resumed = train_cli.main(args_r + ["--max_epoch", "2", "--checkpoint",
                                       os.path.join(exp, "epoch_1.pt")])
    if resumed.step != steps_2:
        raise AssertionError(f"resume from epoch 1 (step {steps_1}) ended at "
                             f"step {resumed.step}, not {steps_2}")
    out["steps"] = {"epoch_1": steps_1, "epoch_2": steps_2,
                    "resumed_epoch_2": resumed.step,
                    "resumed_applied_updates": resumed.n_applied}
    hyp = os.path.join(WORK, "train_hyp.txt")
    recognize.main(["--config", os.path.join(exp, "train.json"),
                    "--checkpoint", os.path.join(exp, "epoch_2.pt"),
                    "--test_data", cv_data, "--dict", dict_path,
                    "--result_file", hyp, "--mode", "ctc_greedy_search",
                    "--batch_size", str(N_CV), "--device", "cuda"])
    with open(hyp, encoding="utf-8") as f:
        out["decoded"] = sum(1 for _ in f)
    if out["decoded"] != N_CV:
        raise AssertionError(f"recognize wrote {out['decoded']} lines")
    out["n_train_steps"] = steps_2 + (resumed.step - steps_1)
    out["n_cv_batches"] = 3 * n_cv
    return out


def check_train_counts(run: dict, counts: dict,
                       decode_batches: int = 1) -> None:
    steps, cv = run["n_train_steps"], run["n_cv_batches"]
    want = {"depthwise_conv1d": 12 * (steps + cv + decode_batches),
            "depthwise_conv1d_dgrad": 12 * steps,
            "depthwise_conv1d_wgrad": 12 * steps}
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{name} launched {counts[name]} times, "
                                 f"expected {n} ({steps} train steps, {cv} "
                                 f"cv batches, {decode_batches} decoded "
                                 f"batches): {counts}")
    n_ctc = counts["ctc_dp_shared"] + counts["ctc_dp_global"]
    if n_ctc != steps + cv or not counts["ctc_dp_shared"] \
            or not counts["ctc_dp_global"]:
        raise AssertionError(f"CTC kernels launched {counts}, expected "
                             f"{steps + cv} in all with both variants")


def _host_batches(manifest: str, dict_path: str, n: int) -> dict:
    ds = AudioDataset(manifest, load_dict(dict_path), batch_size=n,
                      batch_type="static")
    return AudioCollate()(ds[0])[1]


def _features(host: dict, dev: torch.device, frontend: FrontendConfig,
              train: bool = False, gen=None) -> dict:
    b = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    feats, flens = compute_features(b["wav"], b["wav_lens"], frontend, train,
                                    gen)
    return {"features": feats, "features_length": flens,
            "targets": b["targets"], "targets_length": b["targets_length"]}


def _flagship(dtype: str, dropout: float) -> torch.nn.Module:
    conf = dict(TRAIN_CONFIG["model_conf"], compute_dtype=dtype,
                dropout_rate=dropout)
    model = build_asr_model(conf, 80, VOCAB)
    init_parameters(model, make_generator(SEED))
    return model


def gpu_vs_cpu_step(manifest: str, dict_path: str) -> dict:
    """One float32 forward and backward at full width, GPU (kernels) and
    CPU (plain versions), same weights and features, dropout 0."""
    cpu = _flagship("float32", 0.0).train()
    gpu = copy.deepcopy(cpu).cuda().train()
    host = _host_batches(manifest, dict_path, 4)
    fe = FrontendConfig()
    batch = _features(host, torch.device("cpu"), fe)
    res = {}
    grads = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        dev = next(model.parameters()).device
        b = {k: v.to(dev) for k, v in batch.items()}
        metrics = model(*b.values())
        metrics["loss"].backward()
        res[name] = {k: float(v) for k, v in metrics.items()}
        grads[name] = {n: p.grad.detach().cpu()
                       for n, p in model.named_parameters()}
    norm = {k: float(torch.stack([g.square().sum() for g in v.values()])
                     .sum().sqrt()) for k, v in grads.items()}
    g_max = max(float(g.abs().max()) for g in grads["cpu"].values())
    worst = []
    for n, ref in grads["cpu"].items():
        err = float((grads["gpu"][n] - ref).abs().max())
        if not n.endswith("linear_k.bias"):   # zero by shift invariance
            worst.append((err / max(float(ref.abs().max()), 1e-30), err, n))
        # the second term covers the attention key biases, whose
        # gradient is zero by the softmax's shift invariance and so is
        # rounding noise on both devices
        if err > STEP_GRAD_TOL * float(ref.abs().max()) + 1e-5 * g_max:
            raise AssertionError(f"gradient of {n}: GPU vs CPU max abs err "
                                 f"{err}, max |grad| {float(ref.abs().max())}")
    out = {"cpu": res["cpu"], "gpu": res["gpu"], "grad_norm": norm,
           "worst_grad_rel_err": sorted(worst, reverse=True)[:5],
           "batch_shape": list(batch["features"].shape)}
    for k in ("loss", "loss_ctc", "loss_att"):
        rel = abs(res["gpu"][k] - res["cpu"][k]) / abs(res["cpu"][k])
        out[f"{k}_rel_err"] = rel
        if rel > STEP_LOSS_TOL:
            raise AssertionError(f"{k}: GPU vs CPU relative error {rel}")
    out["acc_abs_err"] = abs(res["gpu"]["acc"] - res["cpu"]["acc"])
    out["grad_norm_rel_err"] = abs(norm["gpu"] - norm["cpu"]) / norm["cpu"]
    if out["grad_norm_rel_err"] > STEP_GRAD_TOL:
        raise AssertionError(f"grad norm GPU {norm['gpu']} CPU "
                             f"{norm['cpu']}")
    return out


def overfit(manifest: str, dict_path: str, steps: int = 30) -> dict:
    """Adam on one repeated 8-utterance batch, bf16, dropout 0, no
    SpecAugment: only the parameters change from step to step."""
    dev = torch.device("cuda")
    model = _flagship("bfloat16", 0.0).to(dev)
    batch = _features(_host_batches(manifest, dict_path, 8), dev,
                      FrontendConfig())
    opt, schedule = build_optimizer(model, 1e-3, 10)
    state = TrainState(model, opt)
    step = build_train_step(schedule, 1, 5.0)
    losses = [float(step(state, batch, None)["loss"]) for _ in range(steps)]
    ratio = statistics.mean(losses[-5:]) / losses[0]
    if not ratio < 0.9:
        raise AssertionError(f"overfit ratio {ratio}: {losses}")
    return {"losses": losses, "ratio_last5_over_first": ratio}


def train_breakdown(manifest: str, dict_path: str, n_steps: int = 6) -> dict:
    """Per step at the flagship bf16 setting (dropout 0.1, SpecAugment):
    host collate, frontend, forward, backward, clip+optimizer from host
    clocks around synchronized work (first step left out as warm-up),
    then the device's idle share over 5 profiled steps."""
    dev = torch.device("cuda")
    model = _flagship("bfloat16", 0.1).to(dev).train()
    dc = TRAIN_CONFIG["dataset_conf"]
    ds = AudioDataset(manifest, load_dict(dict_path),
                      max_length=dc["max_length"],
                      min_length=dc["min_length"], batch_type="dynamic",
                      max_frames_in_batch=dc["max_frames_in_batch"])
    fe = FrontendConfig.from_collate_conf(TRAIN_CONFIG["collate_conf"])
    opt, schedule = build_optimizer(model, 1e-3, 4)
    state = TrainState(model, opt)
    gen = make_generator(SEED, dev)
    set_generator(model, gen)
    order = [i % len(ds) for i in range(n_steps)]
    t0 = time.perf_counter()
    hosts = [AudioCollate()(ds[i])[1] for i in order]
    out = {"host_collate_s_per_batch": (time.perf_counter() - t0) / n_steps}

    def one_step(host, lap):
        b = _features(host, dev, fe, True, gen)
        lap("frontend")
        metrics = model(*b.values())
        lap("forward")
        opt.zero_grad(set_to_none=True)
        metrics["loss"].backward()
        lap("backward")
        apply_update(state, schedule, 5.0)
        lap("clip_optimizer")
        return float(b["features_length"].sum()) * 0.01

    torch.cuda.reset_peak_memory_stats()
    stages: dict[str, list] = {}
    audio_s = wall_s = 0.0
    for i, host in enumerate(hosts):
        run = {}
        torch.cuda.synchronize()
        clock = [time.perf_counter()]

        def lap(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            run[name] = now - clock[0]
            clock[0] = now

        start = clock[0]
        seconds = one_step(host, lap)
        if i == 0:
            continue
        wall_s += time.perf_counter() - start
        audio_s += seconds
        for k, v in run.items():
            stages.setdefault(k, []).append(v)
    out["stage_s_per_step"] = {k: statistics.median(v)
                               for k, v in stages.items()}
    out["audio_s_per_s"] = audio_s / wall_s
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for host in hosts[1:6]:
            one_step(host, lambda name: None)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = _device_busy_us(prof)
    out["profiled_steps"] = 5
    out["profiled_wall_s"] = wall_us / 1e6
    out["device_busy_s"] = busy_us / 1e6
    out["device_idle_share"] = 1.0 - busy_us / wall_us if busy_us else None
    out["batches"] = [list(h["wav"].shape) for h in hosts]
    return out


# ---------------------------------------------------------------- main

def _kernel_row(name: str, source: str, replaces: str, launches: int,
                row: dict, prefix: str = "") -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row[f"{prefix}max_abs_err"],
            "ms": row[f"{prefix}ms"], "plain_ms": row[f"{prefix}plain_ms"],
            "bound_ms": row[f"{prefix}bound_ms"],
            "bound_by": row[f"{prefix}bound_by"],
            "library_ms": row[f"{prefix}library_ms"]}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False")
    card = card_line()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()
    try:
        t0 = time.perf_counter()
        sources = [dw.SOURCE, ctc.SOURCE]
        nvcc.build_libraries(sources)
        report["build_s"] = time.perf_counter() - t0
        report["ptxas"] = {s: nvcc.ptxas_entries(nvcc.build_log(s))
                           for s in sources}
        print(f"kernels built in {report['build_s']:.2f} s", flush=True)
        for source, entries in report["ptxas"].items():
            for e in entries:
                print(f"ptxas {source} {json.dumps(e)}", flush=True)
        spilled = [e for entries in report["ptxas"].values() for e in entries
                   if e["spill_stores"] or e["spill_loads"]]
        if spilled:
            raise AssertionError(f"kernels spill: {spilled}")

        rng = np.random.default_rng(SEED)
        manifest, dict_path, durations = write_corpus(rng)
        train_data, cv_data, train_audio_s = write_train_corpus(rng)
        main_shapes = main_path_shapes(durations)
        tshapes = train_shapes(train_data, dict_path)
        report["train_batch_shapes"] = tshapes
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        shapes = [(8, 138, 256, 15), (3, 40, 100, 7), (1, 15, 4, 15)] \
            + main_shapes
        rows = []
        for shape in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                row = kernel_case(*shape, dtype, gen)
                rows.append(row)
                print("K3 " + json.dumps(row), flush=True)
        # the streaming chunk step's shapes, [S, K - 1 + c, 256]: the
        # conv cache in front of the chunk, by TMA and bit-equal to the
        # plain version in both dtypes
        chunk_rows = []
        for shape in ((1, 14 + CHUNK, 256, 15), (8, 14 + CHUNK, 256, 15)):
            for dtype in (torch.float32, torch.bfloat16):
                row = kernel_case(*shape, dtype, gen, exact=True)
                if row["route"] != "tma":
                    raise AssertionError(f"chunk shape not by TMA: {row}")
                chunk_rows.append(row)
                print("K3 chunk " + json.dumps(row), flush=True)
        report["k3_chunk_cases"] = chunk_rows
        # the element-load route: odd C in bfloat16, a 2-byte-offset input
        for shape, offset in (((3, 40, 99, 7), False),
                              ((2, 40, 256, 7), True)):
            row = kernel_case(*shape, torch.bfloat16, gen, offset=offset)
            if row["route"] != "element":
                raise AssertionError(f"not the element route: {row}")
            rows.append(row)
            print("K3 " + json.dumps(row), flush=True)
        report["k3_cases"] = rows

        # ---- training kernels at the training run's shapes and beyond
        train_grad_shapes = sorted({(b, t + 14, 256, 15)
                                    for b, t, _ in tshapes})
        grad_shapes = train_grad_shapes + [(12, 212, 256, 15),
                                           (3, 40, 100, 7), (1, 15, 4, 15)]
        grad_rows = []
        for shape in grad_shapes:
            for dtype in (torch.float32, torch.bfloat16):
                row = dwconv_grad_case(*shape, dtype, gen)
                grad_rows.append(row)
                print("K3 bwd " + json.dumps(row), flush=True)
        for shape, offset in (((3, 40, 99, 7), False),
                              ((2, 40, 256, 7), True)):
            row = dwconv_grad_case(*shape, torch.bfloat16, gen, offset=offset)
            if row["dgrad_route"] != "element" \
                    or row["wgrad_route"] != "element":
                raise AssertionError(f"not the element route: {row}")
            grad_rows.append(row)
            print("K3 bwd " + json.dumps(row), flush=True)
        report["k3_backward_cases"] = grad_rows
        report["k3_kernels_per_call"] = k3_kernels_per_call(
            [(8, 212, 256, 15, torch.float32),
             (8, 212, 256, 15, torch.bfloat16),
             (3, 40, 100, 7, torch.bfloat16)], [(14, 198, 24), (2, 1200, 24)],
            gen)
        if [r["call"] for r in report["k3_kernels_per_call"][-2:]] \
                != ["ctc_dp_shared", "ctc_dp_global"]:
            raise AssertionError("the profiler check missed a CTC kernel")
        print("kernels per call "
              + json.dumps(report["k3_kernels_per_call"]), flush=True)
        report["ctc_global_plans"] = check_global_plan()
        report["ctc_chain_step_ms"] = step_ms = ctc.chain_step_ms()
        print(f"CTC chain step {step_ms * 1e6:.1f} ns", flush=True)
        ctc_rows = []
        train_ctc_shapes = sorted(set(tshapes))
        # then the TPU batch, K2 at the JAX package's large shape, K2 at a
        # tall S = 49 and at S = 1001 (8 warps of 4 positions), and K1 at 1
        # and 4 label positions a lane; every case has a row of T + 5
        for b, t, l_pad in train_ctc_shapes + [(256, 77, 24), (8, 1024, 120),
                                               (2, 1200, 24), (2, 1100, 500),
                                               (5, 30, 15), (4, 70, 60)]:
            row = ctc_case(b, t, l_pad, VOCAB, gen, step_ms)
            ctc_rows.append(row)
            print("CTC " + json.dumps(row), flush=True)
        report["ctc_cases"] = ctc_rows

        # ---- slice 1: the decode path through the entry point
        cfg32 = write_config("float32")
        cfg16 = write_config("bfloat16")
        ckpt = os.path.join(WORK, "model.pt")
        torch.save(random_model_state(torch.Generator().manual_seed(SEED)),
                   ckpt)
        audio_s = sum(durations)
        n_batches = len(main_shapes)
        keys = {f"utt{i:03d}" for i in range(N_UTTS)}
        t_enc = {f"utt{i:03d}": encoder_frames(d)
                 for i, d in enumerate(durations)}
        runs = []
        decode_launches = 0
        adaptive = ["--adaptive_steps", "1", "--length_penalty", "0.5"]
        for mode, cfg, tag, extra in (
                [("ctc_greedy_search", cfg32, "warmup", [])]
                + [(m, cfg32, m, []) for m in MODES]
                + [("attention", cfg32, "attention_adaptive", adaptive),
                   ("attention_rescoring", cfg16, "bf16", []),
                   ("attention", cfg16, "attention_bf16", [])]):
            want_ts = cfg == cfg32 and tag in MODES and mode != "attention"
            hyps, wall, launches, ts = run_recognize(
                cfg, ckpt, manifest, dict_path, mode, tag, extra, want_ts)
            decode_launches += launches
            if set(hyps) != keys:
                raise AssertionError(f"{tag}: keys written {sorted(hyps)}")
            if launches != 12 * n_batches:
                raise AssertionError(f"{tag}: K3 launched {launches} times, "
                                     f"expected 12 x {n_batches} batches")
            run = {"run": tag, "mode": mode, "wall_s": wall,
                   "batches": n_batches, "s_per_batch": wall / n_batches,
                   "rtf": wall / audio_s, "k3_launches": launches,
                   "nonempty_hyps": sum(bool(v) for v in hyps.values())}
            if ts is not None:
                run["timestamps"] = check_timestamps(tag, ts, hyps, t_enc)
            runs.append(run)
            print("decode " + json.dumps(run), flush=True)
        report["decode_runs"] = runs
        report["audio_s"] = audio_s
        report["cpu_parity"] = compare_with_cpu(cfg32, ckpt, manifest,
                                                dict_path)
        print("cpu_parity " + json.dumps(report["cpu_parity"]), flush=True)
        report["attention_cache"] = attention_cache_checks(
            cfg32, ckpt, manifest, dict_path)
        print("attention_cache " + json.dumps(report["attention_cache"]),
              flush=True)
        report["breakdown"] = stage_breakdown(cfg32, ckpt, manifest,
                                              dict_path, torch.device("cuda"))
        print("breakdown " + json.dumps(report["breakdown"]), flush=True)

        # ---- slice 2: training through the entry point
        _reset_counts()
        train_run = run_training(train_data, cv_data, dict_path)
        train_counts = _counts()
        check_train_counts(train_run, train_counts)
        train_run["launches"] = train_counts
        train_run["audio_s_per_epoch"] = train_audio_s
        report["train_run"] = train_run
        print("train " + json.dumps({k: v for k, v in train_run.items()
                                     if k != "epochs"}), flush=True)
        report["recipe"] = run_recipe(os.path.join(WORK, "exp"), train_data,
                                      cv_data, dict_path)
        print("recipe " + json.dumps({k: v for k, v in report["recipe"].items()
                                      if k != "decodes"}), flush=True)

        # ---- slice 7: streaming through its entry points
        cfg_s32 = write_stream_config("float32")
        cfg_s16 = write_stream_config("bfloat16")
        ckpt_s = os.path.join(WORK, "stream_model.pt")
        torch.save(random_model_state(
            torch.Generator().manual_seed(SEED + 7), STREAM_MODEL_CONF),
            ckpt_s)
        t0 = time.perf_counter()
        report["stream"] = stream_checks(cfg_s32, ckpt_s, manifest)
        report["stream"]["checks_wall_s"] = time.perf_counter() - t0
        with K3Trace() as trace:
            report["stream_cli"] = stream_cli_runs(
                cfg_s32, cfg_s16, ckpt_s, manifest, dict_path, t_enc)
        stream_launches = sum(r["k3_launches"]
                              for r in report["stream_cli"])
        chunk_tally = Counter(c[:2] for c in trace.calls)
        routes = Counter(c[2] for c in trace.calls)
        if sum(chunk_tally.values()) != stream_launches \
                or set(routes) != {"tma"}:
            raise AssertionError(f"K3 trace {chunk_tally} {routes} vs "
                                 f"count {stream_launches}")
        report["stream_k3_routes"] = dict(routes)
        report["stream_k3_shapes"] = {f"{list(k[0])} {k[1]}": v
                                      for k, v in chunk_tally.items()}
        report["stream_idle"] = stream_idle(cfg_s32, ckpt_s, manifest)
        print("stream_idle " + json.dumps(report["stream_idle"]), flush=True)

        # ---- slice 8: serving and int8 through their entry points
        t0 = time.perf_counter()
        report["serve"] = serve_checks(cfg_s32, ckpt_s, manifest, dict_path)
        report["serve_endpoint"] = serve_endpoint(cfg_s32, ckpt_s, manifest,
                                                  dict_path)
        report["int8"] = int8_checks(cfg_s32, ckpt_s, cfg32, ckpt, manifest,
                                     dict_path, report["serve"]["finals"])
        report["serve_int8_wall_s"] = time.perf_counter() - t0
        # K3's launches at the chunk-step shape while serving
        serve_launches = (report["serve"]["k3_launches"]
                          + report["serve"]["profiled_k3_launches"]
                          + report["int8"]["serve"]["k3_launches"])
        shape = f"{[SERVE_SLOTS, 14 + CHUNK, 256]} float32"
        report["stream_k3_shapes"][shape] = \
            report["stream_k3_shapes"].get(shape, 0) + serve_launches
        report["stream_training"] = stream_training(train_data, cv_data,
                                                    dict_path)
        print("stream_training " + json.dumps(
            {k: v for k, v in report["stream_training"].items()
             if k != "cv"}), flush=True)
        stream_train_k3 = report["stream_training"]["launches"]
        train_counts = {k: v + stream_train_k3[k]
                        for k, v in train_counts.items()}

        report["train_step_gpu_vs_cpu"] = gpu_vs_cpu_step(train_data,
                                                          dict_path)
        print("train_step_gpu_vs_cpu "
              + json.dumps(report["train_step_gpu_vs_cpu"]), flush=True)
        report["overfit"] = overfit(train_data, dict_path)
        print("overfit " + json.dumps(report["overfit"]), flush=True)
        report["train_breakdown"] = train_breakdown(train_data, dict_path)
        print("train_breakdown " + json.dumps(report["train_breakdown"]),
              flush=True)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    report["wall_s"] = time.perf_counter() - t_start

    # the JSON line reports each kernel at the main path's largest shape,
    # float32 for K3
    k3 = next(r for r in rows if r["dtype"] == "float32"
              and (*r["shape"], r["k"]) == main_shapes[-1])
    largest = max(train_grad_shapes, key=lambda s: s[0] * s[1])
    k3b = next(r for r in grad_rows if r["dtype"] == "float32"
               and (*r["shape"], r["k"]) == largest)

    def train_ctc(variant):
        cands = [r for r in ctc_rows[:len(train_ctc_shapes)]
                 if r["variant"] == variant]
        return max(cands, key=lambda r: math.prod(r["shape"]))

    n = train_counts
    kernels = [
        _kernel_row("depthwise_conv1d", "openeat_torch/csrc/depthwise_conv.cu",
                    "openeat_tpu/ops/depthwise_conv.py:39",
                    decode_launches + n["depthwise_conv1d"]
                    + report["recipe"]["k3_launches"] + stream_launches
                    + serve_launches
                    + report["int8"]["recognize"]["k3_launches"], k3),
        _kernel_row("depthwise_conv1d_dgrad",
                    "openeat_torch/csrc/depthwise_conv.cu",
                    "openeat_tpu/ops/depthwise_conv.py:114",
                    n["depthwise_conv1d_dgrad"], k3b, "dgrad_"),
        _kernel_row("depthwise_conv1d_wgrad",
                    "openeat_torch/csrc/depthwise_conv.cu",
                    "openeat_tpu/ops/depthwise_conv.py:119",
                    n["depthwise_conv1d_wgrad"], k3b, "wgrad_"),
        _kernel_row("ctc_dp_shared", "openeat_torch/csrc/ctc_loss.cu",
                    "openeat_tpu/ops/ctc_loss.py:251",
                    n["ctc_dp_shared"], train_ctc("shared")),
        _kernel_row("ctc_dp_global", "openeat_torch/csrc/ctc_loss.cu",
                    "openeat_tpu/ops/ctc_loss.py:139",
                    n["ctc_dp_global"], train_ctc("global")),
    ]
    for row, case in ((kernels[3], train_ctc("shared")),
                      (kernels[4], train_ctc("global"))):
        row["chain_bound_ms"] = case["chain_bound_ms"]
    # K3 at the streaming chunk step's shapes: launches are those of the
    # stream_recognize runs and the servers at that shape and dtype
    for case in chunk_rows:
        shape = f"{case['shape']} {case['dtype']}"
        kernels.append(dict(
            _kernel_row("depthwise_conv1d", "openeat_torch/csrc/"
                        "depthwise_conv.cu",
                        "openeat_tpu/ops/depthwise_conv.py:39",
                        report["stream_k3_shapes"].get(shape, 0), case),
            shape=case["shape"], dtype=case["dtype"],
            copy_ms=case["copy_ms"]))
    report["kernels"] = kernels
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"wall {report['wall_s']:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
