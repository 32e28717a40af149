"""Smoke run of openeat_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and turns TF32
   off for the float32 phases. Builds openeat_torch/csrc/*.cu with nvcc,
   one process per source, all started together, and prints each kernel
   entry's registers and spills (ptxas -v); a K3 entry that spills fails.
2. Kernel phase: holds K3 (openeat_torch/csrc/depthwise_conv.cu) against
   depthwise_conv1d_plain on the card, at the decode shape [8, 138, 256]
   K=15, at ragged shapes (C=100 in bfloat16 takes the cp.async route,
   the rest TMA), and at the shapes the decode runs below give it, in
   float32 (bit-equal) and bfloat16 (<= 1 bf16 ulp of the float32 sum).
   Times the kernel, the plain version and F.conv1d(groups=C) (the
   library yardstick, which the port never calls) as device time per
   call from CUDA-graph replays over inputs rotated through more than
   the 50 MB L2, beside the least time the card needs for the bytes and
   operations.
   Then the training kernels, at the shapes the training run below
   gives them, at fixed larger ones and at ragged ones ([3, 40, 100]
   K=7, and [1, 15, 4] K=15, whose dgrad has T < K): K3's dgrad (the
   kernel's dgrad entry on dy and w as they are; float32 bit-equal to
   the plain dgrad, bfloat16 within 1 bf16 ulp) and wgrad
   (float32 within 1e-5 x max|dw| of the plain sum; bfloat16 within 1
   bf16 ulp of the kernel's own float32 sums), with
   aten.convolution_backward as their yardstick. torch.profiler shows
   that one depthwise_conv1d call and one depthwise_conv1d_dgrad call
   each run exactly one device kernel, on both routes. Then the CTC
   forward-backward K1/K2 counterparts (openeat_torch/csrc/ctc_loss.cu)
   against the plain recursions (loss within 1e-5 relative, gamma
   within 1e-4 on finite entries, NEG_INF entries equal), with repeats,
   an infeasible row and len == 1 in every case. The port's whole CTC
   op (gather, kernel, scatter; forward and backward) is timed beside
   F.ctc_loss forward and backward at the same (B, T, V, L), the
   yardstick the port never calls.
3. Slice phase: writes 16 synthetic 3-8 s wavs, a 4233-entry dict, the
   flagship AIShell Conformer config (examples/aishell/conf/
   train_conformer.yaml model_conf: d=256, 12 blocks, 3+3 decoders) as
   JSON and a model with seeded random weights, then runs
   openeat_torch.bin.recognize on cuda in the three modes at batch 8.
   Checks that every key is written, that K3 launched 12 times per
   encoded batch, and that in float32 the encoder output and CTC
   log-probs match a CPU run of the same model (plain path) within
   ENC_TOL, greedy tokens agreeing wherever the CPU top-2 margin exceeds
   10 x ENC_TOL. Then decodes once with compute_dtype bfloat16.
4. Breakdown: model load, host collate and each decode stage per batch,
   and the device's idle share over one rescoring pass (torch.profiler).
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
6. One float32 train step, GPU against CPU, on a 4-utterance batch at
   full width (dropout 0, SpecAugment off, TF32 off, same weights).
7. Overfit: 30 steps on one repeated 8-utterance batch (dropout 0,
   SpecAugment off); the mean loss of the last 5 must be below 0.9 x
   the first.
8. Training breakdown at the flagship bf16 setting: frontend, forward,
   backward, clip+optimizer per step (host clock around synchronized
   work), the device's idle share over 5 steps (torch.profiler), peak
   memory and audio seconds trained per second.

Any failed check raises. The last stdout line is the JSON result;
details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import copy
import json
import math
import os
import shutil
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from openeat_torch.bin import recognize
from openeat_torch.bin import train as train_cli
from openeat_torch.dataset.audio import write_wav
from openeat_torch.dataset.dataset import (AudioCollate, AudioDataset,
                                           PrefetchLoader)
from openeat_torch.dataset.text import load_dict
from openeat_torch.decode.ctc_greedy import ctc_greedy_search
from openeat_torch.decode.ctc_prefix_beam import ctc_prefix_beam_search
from openeat_torch.decode.rescoring import attention_rescoring
from openeat_torch.models.asr_model import build_asr_model, init_parameters
from openeat_torch.modules.dropout import set_generator
from openeat_torch.ops import ctc_loss as ctc
from openeat_torch.ops import depthwise_conv as dw
from openeat_torch.ops import nvcc
from openeat_torch.ops.frontend import FrontendConfig, compute_features
from openeat_torch.parallel.train_step import (TrainState, apply_update,
                                               build_train_step)
from openeat_torch.pipeline import DeviceFeeder
from openeat_torch.utils.common import make_generator
from openeat_torch.utils.optim import build_optimizer

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
MODES = ["ctc_greedy_search", "ctc_prefix_beam_search",
         "attention_rescoring"]
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

def kernel_case(b: int, tp: int, c: int, k: int, dtype, gen) -> dict:
    dev = torch.device("cuda")
    x32 = torch.randn((b, tp, c), generator=gen, device=dev)
    w32 = torch.randn((k, c), generator=gen, device=dev) * 0.3
    x, w = x32.to(dtype), w32.to(dtype)
    out = dw.depthwise_conv1d(x, w)
    plain = dw.depthwise_conv1d_plain(x, w)
    torch.cuda.synchronize()
    assert out.shape == (b, tp - k + 1, c) and out.dtype == dtype
    err = (out.float() - plain.float()).abs()
    row = {"shape": [b, tp, c], "k": k, "dtype": str(dtype).split(".")[-1],
           "route": dw.device_plan(x, k, dgrad=False).route,
           "max_abs_err": float(err.max())}
    if dtype == torch.float32:
        ok = row["max_abs_err"] == 0.0
    else:
        ulp = bf16_ulp(dw.depthwise_conv1d_plain(x.float(), w.float()))
        row["max_err_ulps"] = float((err / ulp).max())
        ok = row["max_err_ulps"] <= 1.0
    if not ok:
        raise AssertionError(f"K3 disagrees with its plain version: {row}")

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


def random_model_state(gen: torch.Generator) -> dict:
    """Full-width model with weights drawn from `gen`: matrices scaled by
    1/sqrt(fan_in), LayerNorm gains near 1, small biases."""
    model = build_asr_model(FLAGSHIP_MODEL_CONF, 80, VOCAB)
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
                  mode: str, tag: str) -> tuple[dict, float, int]:
    out = os.path.join(WORK, f"hyp_{tag}.txt")
    dw.depthwise_conv1d.launches = 0
    t0 = time.perf_counter()
    recognize.main(["--config", cfg, "--checkpoint", ckpt, "--test_data",
                    manifest, "--dict", dict_path, "--result_file", out,
                    "--mode", mode, "--batch_size", str(BATCH),
                    "--reverse_weight", "0.3", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dw.depthwise_conv1d.launches
    with open(out, encoding="utf-8") as f:
        hyps = dict((line.rstrip("\n").split(" ", 1) + [""])[:2]
                    for line in f)
    return hyps, wall, launches


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
    median of 3 passes over both batches); then the device's busy share
    over one full attention_rescoring pass, from torch.profiler's kernel
    and copy events."""
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
            nbest = ctc_prefix_beam_search(lp, enc_lens, beam_size=10,
                                           max_hyp_len=64)
            lap("prefix_beam_search")
            attention_rescoring(model, enc, enc_lens, *nbest,
                                ctc_weight=0.5, reverse_weight=0.3)
            lap("rescoring")

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
            one_pass(lap)
            for name, s in run.items():
                totals.setdefault(name, []).append(s / len(wavs))
        out["stage_s_per_batch"] = {k: statistics.median(v)
                                    for k, v in totals.items()}
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_pass(lambda name: None)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    out["profiled_wall_s"] = wall_us / 1e6
    out["device_busy_s"] = busy_us / 1e6
    # no device events means the profiler could not trace the card
    out["device_idle_share"] = 1.0 - busy_us / wall_us if busy_us else None
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

def dwconv_grad_case(b: int, tp: int, c: int, k: int, dtype, gen) -> dict:
    """K3 dgrad and wgrad against their plain versions; times."""
    dev = torch.device("cuda")
    t = tp - k + 1
    x = torch.randn((b, tp, c), generator=gen, device=dev).to(dtype)
    dy = torch.randn((b, t, c), generator=gen, device=dev).to(dtype)
    w = (torch.randn((k, c), generator=gen, device=dev) * 0.3).to(dtype)
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
           "dgrad_max_abs_err": dgrad_err, "wgrad_max_abs_err": wgrad_err,
           "wgrad_rel_err": wgrad_err / float(w_ref.abs().max()),
           "wgrad_vs_plain_max_abs_err": float(
               (dwk.float() - dw_plain.float()).abs().max())}
    if dtype == torch.float32:
        ok = dgrad_err == 0.0 and row["wgrad_rel_err"] <= 1e-5
        if not torch.equal(dw.depthwise_conv1d_wgrad(x, dy), dwk):
            raise AssertionError("wgrad differs between two runs")
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


def k3_kernels_per_call(shapes: list[tuple], gen) -> list[dict]:
    """torch.profiler over one depthwise_conv1d call and one
    depthwise_conv1d_dgrad call (each after a warm-up call): each must run
    exactly one device kernel."""
    from torch.profiler import ProfilerActivity, profile
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
                            lambda: dw.depthwise_conv1d_dgrad(dy, w))):
            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            kernels = [e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            row = {"call": name, "shape": [b, tp, c], "k": k,
                   "dtype": str(dtype).split(".")[-1], "kernels": kernels}
            if len(kernels) != 1:
                raise AssertionError(f"one K3 call ran {len(kernels)} device "
                                     f"kernels: {row}")
            rows.append(row)
    return rows


# ---------------------------------------------------------------- CTC

def ctc_problem(b: int, t: int, l_pad: int, v: int, gen) -> dict:
    """Log-probs [B, T, V] and labels [B, L] on the card with a repeated
    label, an infeasible row (more labels than frames) and len == 1."""
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
    return {"log_probs": lp, "labels": labels, "il": il, "ll": ll}


def ctc_case(b: int, t: int, l_pad: int, v: int, gen) -> dict:
    """The CTC kernel dispatch_variant picks at [B, T, S=2L+1] against
    the plain recursions; times of the kernel alone, the plain version,
    the port's whole CTC op and F.ctc_loss (forward and backward)."""
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
           "loss_rel_err": float(((loss - ref_loss).abs()
                                  / ref_loss.abs().clamp(min=1e-6)).max()),
           "gamma_max_abs_err": float((gamma - ref_gamma).abs()[fin].max()),
           "neg_inf_equal": bool(torch.equal(gamma <= -1e29, ~fin)),
           "infeasible_loss": float(loss[2]) if b > 2 else None}
    row["max_abs_err"] = row["gamma_max_abs_err"]
    if not (row["loss_rel_err"] <= 1e-5 and row["gamma_max_abs_err"] <= 1e-4
            and row["neg_inf_equal"]):
        raise AssertionError(f"CTC kernel disagrees with its plain version: "
                             f"{row}")

    nbytes = 2 * llp.numel() * 4 + allow2.numel() + 3 * b * 4
    n = _n_copies(nbytes)
    llps = [llp.clone() for _ in range(n)]
    row["ms"] = device_ms(lambda i: kernel(llps[i], p["il"], s_lens, allow2),
                          n)
    row["plain_ms"] = event_ms(lambda: ctc.ctc_dp_plain(
        llp, p["il"], s_lens, allow2), reps=2)
    # the bytes bound; 2*T dependent steps make the kernel latency-bound
    row["bound_ms"], row["bound_by"] = _bound(nbytes, 20.0 * b * t * s)

    lp = p["log_probs"].detach().requires_grad_()
    lp_tbv = p["log_probs"].transpose(0, 1).detach().requires_grad_()

    def port_op():
        per = ctc.ctc_loss(lp, p["il"], p["labels"], p["ll"])
        torch.autograd.grad(per.sum(), lp)

    def library_op():
        loss = F.ctc_loss(lp_tbv, p["labels"], p["il"], p["ll"], blank=0,
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


def check_train_counts(run: dict, counts: dict) -> None:
    steps, cv = run["n_train_steps"], run["n_cv_batches"]
    decode_batches = 1
    want = {"depthwise_conv1d": 12 * (steps + cv + decode_batches),
            "depthwise_conv1d_dgrad": 12 * steps,
            "depthwise_conv1d_wgrad": 12 * steps}
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{name} launched {counts[name]} times, "
                                 f"expected {n} ({steps} train steps, {cv} "
                                 f"cv batches, 1 decoded batch): {counts}")
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
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
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
        spilled = [e for e in report["ptxas"][dw.SOURCE]
                   if e["spill_stores"] or e["spill_loads"]]
        if spilled:
            raise AssertionError(f"K3 kernels spill: {spilled}")

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
        report["k3_backward_cases"] = grad_rows
        report["k3_kernels_per_call"] = k3_kernels_per_call(
            [(8, 212, 256, 15, torch.float32),
             (8, 212, 256, 15, torch.bfloat16),
             (3, 40, 100, 7, torch.bfloat16)], gen)
        print("K3 kernels per call "
              + json.dumps(report["k3_kernels_per_call"]), flush=True)
        ctc_rows = []
        for b, t, l_pad in sorted(set(tshapes)) + [(256, 77, 24),
                                                    (8, 1024, 120)]:
            row = ctc_case(b, t, l_pad, VOCAB, gen)
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
        runs = []
        decode_launches = 0
        for mode, cfg, tag in ([("ctc_greedy_search", cfg32, "warmup")]
                               + [(m, cfg32, m) for m in MODES]
                               + [("attention_rescoring", cfg16, "bf16")]):
            hyps, wall, launches = run_recognize(cfg, ckpt, manifest,
                                                 dict_path, mode, tag)
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
            runs.append(run)
            print("decode " + json.dumps(run), flush=True)
        report["decode_runs"] = runs
        report["audio_s"] = audio_s
        report["cpu_parity"] = compare_with_cpu(cfg32, ckpt, manifest,
                                                dict_path)
        print("cpu_parity " + json.dumps(report["cpu_parity"]), flush=True)
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
        cands = [r for r in ctc_rows[:-2] if r["variant"] == variant]
        return max(cands, key=lambda r: math.prod(r["shape"]))

    n = train_counts
    kernels = [
        _kernel_row("depthwise_conv1d", "openeat_torch/csrc/depthwise_conv.cu",
                    "openeat_tpu/ops/depthwise_conv.py:39",
                    decode_launches + n["depthwise_conv1d"], k3),
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
    report["kernels"] = kernels
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"wall {report['wall_s']:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
