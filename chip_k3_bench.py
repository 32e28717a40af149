"""Times K3's forward and dgrad on one NVIDIA GPU, in one checkout.

    python3 chip_k3_bench.py [TREE]

Runs with TREE's openeat_torch and chip_smoke.py (default: the checkout
that holds this script). At the main path's shapes, in float32 and
bfloat16, chip_smoke's kernel_case (the forward) and dwconv_grad_case
(dgrad and wgrad) check each kernel against its plain version and time
the kernel, the plain version and the library call from CUDA-graph
replays. Beside them it times a ``Tensor.copy_`` of the kernel's input
(what moving those bytes costs at this size) and the host's microseconds
per call of ``depthwise_conv1d`` and ``depthwise_conv1d_dgrad``: the
wrapper's whole host path, launch included, median of 400 calls. Prints
one JSON line per case and appends them, with the card and TREE, to
chiprun_out/k3_bench.jsonl. To compare two checkouts, run both in one
call on one card, in the order parent, change, change, parent.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")
# (B, T+K-1, C, K): the decode batches, then the training batches (the
# forward and dgrad of each) and one larger one
FORWARD_SHAPES = [(8, 162, 256, 15), (8, 212, 256, 15), (22, 162, 256, 15),
                  (14, 212, 256, 15), (6, 512, 256, 15)]
DGRAD_SHAPES = [(22, 162, 256, 15), (14, 212, 256, 15), (6, 512, 256, 15),
                (12, 212, 256, 15)]


def host_us(call, n: int = 400) -> float:
    """Median host microseconds of one call, the card drained every 50
    calls (outside the timing) so that no launch waits on a full queue."""
    import torch
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    times = []
    for i in range(n):
        t0 = time.perf_counter_ns()
        call()
        times.append(time.perf_counter_ns() - t0)
        if i % 50 == 49:
            torch.cuda.synchronize()
    return statistics.median(times) / 1e3


def main() -> None:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                           else os.path.dirname(os.path.abspath(__file__)))
    if len(sys.argv) > 2:
        raise SystemExit(__doc__)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from openeat_torch.ops import depthwise_conv as dw
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(20261016)
    rows = []
    for kind, shapes in (("forward", FORWARD_SHAPES),
                         ("backward", DGRAD_SHAPES)):
        for b, tp, c, k in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                if kind == "forward":
                    row = cs.kernel_case(b, tp, c, k, dtype, gen)
                    src = torch.randn((b, tp, c), generator=gen,
                                      device="cuda").to(dtype)
                else:
                    row = cs.dwconv_grad_case(b, tp, c, k, dtype, gen)
                    src = torch.randn((b, tp - k + 1, c), generator=gen,
                                      device="cuda").to(dtype)
                w = (torch.randn((k, c), generator=gen, device="cuda")
                     * 0.3).to(dtype)
                n = cs._n_copies(2 * src.numel() * src.element_size())
                srcs = [src.clone() for _ in range(n)]
                dsts = [torch.empty_like(src) for _ in range(n)]
                row["copy_ms"] = cs.device_ms(
                    lambda i: dsts[i].copy_(srcs[i]), n)
                if kind == "forward":
                    row["host_us"] = host_us(
                        lambda: dw.depthwise_conv1d(src, w))
                else:
                    row["dgrad_host_us"] = host_us(
                        lambda: dw.depthwise_conv1d_dgrad(src, w))
                row.update(kind=kind, tree=tree, card=card)
                rows.append(row)
                print(json.dumps(row), flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "k3_bench.jsonl"), "a") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
