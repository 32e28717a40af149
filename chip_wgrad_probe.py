"""The K = 31 wgrad's design steps on one NVIDIA GPU, rebuilt from the
shipped source.

    python3 chip_wgrad_probe.py

Builds variants of openeat_torch/csrc/depthwise_conv.cu with nvcc (one
process each, all started together, into chiprun_out/wgrad_probe_build),
each a text substitution of the shipped source:

- ``run_time_route``: K = 31 through the run-time-K route (passes of
  W_KC taps, 32-channel tiles, the workspace and its ticket), the design
  before the K = 31 instance;
- ``step_a``: the K = 31 instance in one pass of two tap groups, with the
  K = 15 tiling (32-channel tiles) and the workspace's last-block sum;
- ``cluster_256``: the shipped design with 32 row groups (256 threads a
  block);
- ``no_exit``: the shipped design without the row loop's early exit (on
  the TMA route, the only one that takes it);
- ``shipped``: the source as it is;
- ``shipped_stamps``: the source with globaltimer and clock64 stamps of
  each block's thread 0 at K = 31 (start, first item landed, its sums
  done, row groups in shared memory, end of the cluster's sum), and a
  multiply-add loop that measures the FP32 issue rate;
- ``no_sums_stamps``: as ``shipped_stamps`` with the row loop emptied
  (timing only: its dw is wrong).

Each variant's openeat_dwconv1d_wgrad is called by ctypes on the
LibriSpeech micro-batches (and K = 15 at [22, 162, 256]) in float32 and
bfloat16, checked against depthwise_conv1d_wgrad_plain (relative error)
and for the same bits on two runs, and timed from CUDA-graph replays over
inputs rotated through more than the L2 (chip_smoke.device_ms). One JSON
line per case goes to stdout and to chiprun_out/wgrad_probe.jsonl.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

import torch

import chip_smoke as cs
from openeat_torch.ops import depthwise_conv as dw
from openeat_torch.ops import nvcc

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
BUILD = os.path.join(OUT_DIR, "wgrad_probe_build")
SHAPES = [(4, 353, 256, 31), (3, 428, 256, 31), (2, 453, 256, 31),
          (22, 162, 256, 15)]
N_STAMPS = 8
MAX_BLOCKS = 8192

STAMP_DEFS = r"""
__device__ unsigned long long g_stamps[8192][8];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(i) \
  if (tid == 0) g_stamps[blockIdx.y * gridDim.x + blockIdx.x][i] = gtime();
#define CLK(i) \
  if (tid == 0) g_stamps[blockIdx.y * gridDim.x + blockIdx.x][i] = clock64();
"""

FMA_PROBE = r"""
__global__ void fma_probe(float* out, long long* clk, int iters) {
  float a[16];
  for (int i = 0; i < 16; ++i) a[i] = threadIdx.x * 1e-3f + i;
  const long long c0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] = fmaf(a[i], 1.0001f, 1e-4f);
  }
  const long long c1 = clock64();
  float s = 0.0f;
  for (int i = 0; i < 16; ++i) s += a[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) clk[blockIdx.x] = c1 - c0;
}
extern "C" int probe_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));
}
extern "C" int run_fma_probe(float* out, long long* clk, int blocks,
                             int threads, int iters) {
  fma_probe<<<blocks, threads>>>(out, clk, iters);
  return (int)cudaDeviceSynchronize();
}
"""


def sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise AssertionError(f"the source changed: {old!r}")
    return src.replace(old, new)


def const(src: str, name: str, value: int) -> str:
    out, n = re.subn(rf"constexpr int {name} = \d+;",
                     f"constexpr int {name} = {value};", src)
    if n != 1:
        raise AssertionError(name)
    return out


def run_time_route(src: str) -> str:
    return sub(src, "w->kf = k == K_FIXED || k == K_WIDE ? k : 0;",
               "w->kf = k == K_FIXED ? k : 0;")


def step_a(src: str) -> str:
    src = sub(src, "  constexpr bool CLUSTER = KF == K_WIDE;",
              "  constexpr bool CLUSTER = false;")
    src = sub(src, "  w->cluster = w->kf == K_WIDE;", "  w->cluster = 0;")
    src = sub(src, "  if constexpr (KF == K_WIDE) {\n    // a cluster",
              "  if constexpr (false) {\n    // a cluster")
    return const(src, "W_WIDE_C_TILE", 32)


def no_exit(src: str) -> str:
    return sub(src, "wgrad_rows<KC, CLUSTER && G == 0>(",
               "wgrad_rows<KC, false>(")


def stamped(src: str) -> str:
    src = sub(src, "struct WParams {", STAMP_DEFS + "struct WParams {")
    src = sub(src, "  const int n_mine = min(p.per, p.n_items - i0);\n",
              "  const int n_mine = min(p.per, p.n_items - i0);\n"
              "  STAMP(0)\n")
    src = sub(src, "      mbar_wait(&full[s], (uint32_t)(n / W_STAGES) & 1u);",
              "      mbar_wait(&full[s], (uint32_t)(n / W_STAGES) & 1u);\n"
              "      if (n == 0) { STAMP(1) CLK(6) }")
    sums = " " * 40 + "p.x_rows - 1, keep);\n"
    src = sub(src, sums, sums + "      if (n == 0) { STAMP(2) CLK(7) }\n")
    src = sub(src, "  __syncthreads();  // every row group's sums are in red",
              "  __syncthreads();  // every row group's sums are in red\n"
              "  STAMP(3)")
    src = sub(src, "    }\n    return;\n  }\n  float4* part",
              "    }\n    STAMP(4)\n    return;\n  }\n  float4* part")
    return src + FMA_PROBE


def no_sums(src: str) -> str:
    call = "wgrad_rows<KC, CLUSTER && G == 0>(xs, ds, p.c_tile, lo, "
    return sub(src, call + "hi,", call + "lo,")


def variants() -> dict[str, str]:
    src = (nvcc.CSRC_DIR / dw.SOURCE).read_text()
    return {"run_time_route": run_time_route(src), "step_a": step_a(src),
            "cluster_256": const(src, "W_WIDE_GROUPS", 32),
            "no_exit": no_exit(src), "shipped": src,
            "shipped_stamps": stamped(src),
            "no_sums_stamps": stamped(no_sums(src))}


def build(srcs: dict[str, str]) -> dict[str, ctypes.CDLL]:
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name, src in srcs.items():
        cu = os.path.join(BUILD, name + ".cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(BUILD, name + ".so")
        procs[name] = (so, subprocess.Popen(
            [nvcc.find_nvcc(), *nvcc.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out[-4000:]}")
        for e in nvcc.ptxas_entries(out):
            if "wgrad_kernelI13__nv_bfloat16Li31ELi0E" in e["entry"]:
                print(f"ptxas {name} K=31 bf16 tma: {e['registers']} "
                      f"registers, spills {e['spill_stores']}", flush=True)
        libs[name] = ctypes.CDLL(so)
    return libs


def stamp_stats(lib, n_blocks: int) -> dict:
    """Medians over the blocks of the last launch's stamp intervals, us;
    the span from the first block's start to the last block's end; SM
    clocks per ns over the first item's sums."""
    buf = (ctypes.c_ulonglong * (MAX_BLOCKS * N_STAMPS))()
    lib.probe_stamps.argtypes = [ctypes.c_void_p]
    if lib.probe_stamps(ctypes.addressof(buf)) != 0:
        raise RuntimeError("cudaMemcpyFromSymbol of the stamps failed")
    st = [list(buf[i * N_STAMPS:(i + 1) * N_STAMPS]) for i in range(n_blocks)]
    t0 = min(s[0] for s in st)
    ends = [s[4] for s in st if s[4] >= t0]

    def med(a: int, b: int) -> float:
        return statistics.median(s[b] - s[a] for s in st) / 1e3

    return {"first_item_us": med(0, 1), "sums_us": med(1, 2),
            "red_us": med(2, 3), "tail_us": med(3, 4),
            "span_us": (max(ends) - t0) / 1e3,
            "start_spread_us": (max(s[0] for s in st) - t0) / 1e3,
            "sm_clk_per_ns": statistics.median(
                (s[7] - s[6]) / max(1, s[2] - s[1]) for s in st)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_wgrad_probe.py needs a CUDA card")
    t_start = time.perf_counter()
    card = cs.card_line()
    print(card, flush=True)
    libs = build(variants())
    ws = torch.zeros(1 << 23, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rows = []
    for b, tp, c, k in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            t = tp - k + 1
            x = torch.randn((b, tp, c), generator=gen, device="cuda").to(dtype)
            dy = torch.randn((b, t, c), generator=gen,
                             device="cuda").to(dtype)
            ref = dw.depthwise_conv1d_wgrad_plain(x.float(), dy.float())
            n = cs._n_copies((x.numel() + 2 * dy.numel()) * x.element_size())
            xs = [x.clone() for _ in range(n)]
            dys = [dy.clone() for _ in range(n)]
            outs = [torch.empty((k, c), dtype=dtype, device="cuda")
                    for _ in range(n)]
            row = {"shape": [b, tp, c], "k": k,
                   "dtype": str(dtype).split(".")[-1], "card": card}
            for name, lib in libs.items():
                fn = lib.openeat_dwconv1d_wgrad
                fn.argtypes = list(dw._WGRAD_ARGS)

                def call(xx, dd, out, fn=fn):
                    rc = fn(xx.data_ptr(), dd.data_ptr(), ws.data_ptr(),
                            ws.numel(), out.data_ptr(), b, tp, c, k,
                            0 if dtype == torch.float32 else 1, 0,
                            torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"{name}: launch code {rc}")

                call(x, dy, outs[0])
                call(x, dy, outs[1])
                torch.cuda.synchronize()
                err = float((outs[0].float() - ref).abs().max()
                            / ref.abs().max())
                got = {"us": cs.device_ms(
                    lambda i: call(xs[i], dys[i], outs[i]), n) * 1e3,
                    "rel_err": err,
                    "same_bits": bool(torch.equal(outs[0], outs[1]))}
                if name.endswith("_stamps") and k == dw.K_WIDE:
                    call(x, dy, outs[0])
                    torch.cuda.synchronize()
                    plan = dw.wgrad_plan(b, tp, c, k, x.element_size())
                    got.update(stamp_stats(lib, plan.grid[0] * plan.grid[1]))
                row[name] = got
            rows.append(row)
            print(json.dumps(row), flush=True)
    # FP32 issue rate: 16 independent multiply-add chains a thread, one
    # and two warps a scheduler
    lib = libs["shipped_stamps"]
    lib.run_fma_probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p] \
        + [ctypes.c_int] * 3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for threads in (128, 256):
        out = torch.empty(sms * threads, device="cuda")
        clk = torch.zeros(sms, dtype=torch.int64, device="cuda")
        for _ in range(2):
            lib.run_fma_probe(out.data_ptr(), clk.data_ptr(), sms, threads,
                              20000)
        per_fma = float(clk.double().median()) / (20000 * 16)
        row = {"fma_probe_threads_a_block": threads, "blocks": sms,
               "clocks_per_fma_a_thread": per_fma,
               "warp_fmas_per_clock_a_scheduler": threads / 128 / per_fma,
               "card": card}
        rows.append(row)
        print(json.dumps(row), flush=True)
    with open(os.path.join(OUT_DIR, "wgrad_probe.jsonl"), "a") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    print(f"done in {time.perf_counter() - t_start:.1f} s", flush=True)


if __name__ == "__main__":
    main()
