"""Smoke run of openeat_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and turns TF32
   off for the float32 phases.
2. Kernel phase: builds K3 (openeat_torch/csrc/depthwise_conv.cu) with
   nvcc and holds it against depthwise_conv1d_plain on the card, at the
   decode shape [8, 138, 256] K=15, at ragged shapes, and at the shapes
   the decode runs below give it, in float32 (max abs err <= 1e-5) and
   bfloat16 (<= 1 bf16 ulp of the float32 sum). Times the kernel, the
   plain version and F.conv1d(groups=C) (the library yardstick, which
   the port never calls) as device time per call from CUDA-graph
   replays over inputs rotated through more than the 50 MB L2, beside
   the least time the card needs for the bytes and operations.
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

Any failed check raises. The last stdout line is the JSON result;
details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

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
from openeat_torch.dataset.audio import write_wav
from openeat_torch.dataset.dataset import (AudioCollate, AudioDataset,
                                           PrefetchLoader)
from openeat_torch.dataset.text import load_dict
from openeat_torch.decode.ctc_greedy import ctc_greedy_search
from openeat_torch.decode.ctc_prefix_beam import ctc_prefix_beam_search
from openeat_torch.decode.rescoring import attention_rescoring
from openeat_torch.models.asr_model import build_asr_model
from openeat_torch.ops import depthwise_conv as dw
from openeat_torch.ops import nvcc
from openeat_torch.ops.frontend import FrontendConfig, compute_features
from openeat_torch.pipeline import DeviceFeeder

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
           "max_abs_err": float(err.max())}
    if dtype == torch.float32:
        ok = row["max_abs_err"] <= 1e-5
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


# ---------------------------------------------------------------- main

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
    try:
        t0 = time.perf_counter()
        nvcc.load_library(dw.SOURCE)
        report["k3_build_s"] = time.perf_counter() - t0
        report["k3_ptxas"] = [ln for ln in nvcc.build_log(dw.SOURCE)
                              .splitlines() if "Used" in ln or "spill" in ln]
        print(f"K3 built in {report['k3_build_s']:.2f} s: "
              f"{report['k3_ptxas']}", flush=True)

        rng = np.random.default_rng(SEED)
        manifest, dict_path, durations = write_corpus(rng)
        main_shapes = main_path_shapes(durations)
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

        # ---- slice: the decode path through the entry point
        cfg32 = write_config("float32")
        cfg16 = write_config("bfloat16")
        ckpt = os.path.join(WORK, "model.pt")
        torch.save(random_model_state(torch.Generator().manual_seed(SEED)),
                   ckpt)
        audio_s = sum(durations)
        n_batches = len(main_shapes)
        keys = {f"utt{i:03d}" for i in range(N_UTTS)}
        runs = []
        main_launches = 0
        for mode, cfg, tag in ([("ctc_greedy_search", cfg32, "warmup")]
                               + [(m, cfg32, m) for m in MODES]
                               + [("attention_rescoring", cfg16, "bf16")]):
            hyps, wall, launches = run_recognize(cfg, ckpt, manifest,
                                                 dict_path, mode, tag)
            main_launches += launches
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
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    # the JSON line reports K3 at the main path's largest shape, float32
    k3 = next(r for r in rows if r["dtype"] == "float32"
              and (*r["shape"], r["k"]) == main_shapes[-1])
    kernels = [{
        "name": "depthwise_conv1d", "route": "cuda",
        "source": "openeat_torch/csrc/depthwise_conv.cu",
        "replaces": "openeat_tpu/ops/depthwise_conv.py:39",
        "launches": main_launches, "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"]}]
    report["kernels"] = kernels
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
