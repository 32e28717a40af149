"""Times the hand-written kernels K3, K1 and K2 on one NVIDIA GPU, in
one checkout.

    python3 chip_kernel_bench.py [TREE]

Runs with TREE's openeat_torch and chip_smoke.py (default: the checkout
that holds this script). At the main path's shapes (K3 at K = 15, and
at K = 31 at the LibriSpeech Conformer's training micro-batches), in
float32 and bfloat16, chip_smoke's kernel_case (K3's forward) and
dwconv_grad_case (K3's dgrad and wgrad) check each kernel against its
plain version and time the kernel, the plain version and the library
call from CUDA-graph replays; ctc_row checks the CTC kernel that
dispatch_variant picks bit for bit and times it alone at the training
batches' [B, T, S] (K1 at [22, 148, 33], [14, 198, 49] and the TPU
batch [256, 77, 49]; K2 at the flagship's long batch [6, 498, 241] and
the JAX package's large shape [8, 1024, 241]). Beside them it times a
``Tensor.copy_`` of the kernel's input (for the wgrad, of x and of dy:
what moving those bytes costs at this size) and the host's microseconds
per call of ``depthwise_conv1d`` and ``depthwise_conv1d_dgrad``: the
wrapper's whole host path, launch included, median of 400 calls.
Prints one JSON line per case and appends them, with the card and TREE,
to chiprun_out/kernel_bench.jsonl. To compare two checkouts, run both
in one call on one card, in the order parent, change, change, parent.
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
# forward and the backward of each) and one larger one; then the
# LibriSpeech Conformer's training micro-batches at K = 31
K31_SHAPES = [(4, 353, 256, 31), (3, 428, 256, 31), (2, 453, 256, 31)]
FORWARD_SHAPES = [(8, 162, 256, 15), (8, 212, 256, 15), (22, 162, 256, 15),
                  (14, 212, 256, 15), (6, 512, 256, 15)] + K31_SHAPES
BACKWARD_SHAPES = [(22, 162, 256, 15), (14, 212, 256, 15), (6, 512, 256, 15),
                   (12, 212, 256, 15)] + K31_SHAPES
# (B, T, L): K1 at the flagship's training batches and the TPU batch, K2
# at the flagship's long batch and the JAX package's large shape
CTC_SHAPES = [(22, 148, 16), (14, 198, 24), (256, 77, 24), (6, 498, 120),
              (8, 1024, 120)]
VOCAB = 4233


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


def copy_ms(cs, tensors) -> float:
    """Device time of one ``Tensor.copy_`` of each of `tensors`."""
    import torch
    n = cs._n_copies(2 * sum(t.numel() * t.element_size() for t in tensors))
    srcs = [[t.clone() for t in tensors] for _ in range(n)]
    dsts = [[torch.empty_like(t) for t in tensors] for _ in range(n)]

    def run(i):
        for d, s in zip(dsts[i], srcs[i]):
            d.copy_(s)

    return cs.device_ms(run, n)


def ctc_row(cs, b: int, t: int, l_pad: int, gen) -> dict:
    """The CTC kernel that dispatch_variant picks at [B, T, S=2L+1],
    checked bit for bit against the plain recursions and timed alone, its
    inputs already in the kernel's dtypes (int32 lengths, uint8 skip
    mask), beside its bytes bound and, where the checkout has
    chain_step_ms, its chain bound."""
    import torch
    from openeat_torch.ops import ctc_loss as ctc
    p = cs.ctc_problem(b, t, l_pad, VOCAB, gen)
    z, s_lens = ctc.extended_labels(p["labels"], p["ll"])
    allow2 = ctc.transition_masks(z)
    llp = ctc.gather_label_logp(p["log_probs"], z)
    il, sl, a2 = p["il"].int(), s_lens.int(), allow2.to(torch.uint8)
    s = llp.shape[2]
    variant = ctc.dispatch_variant(b, t, s)
    kernel = ctc.ctc_dp_shared if variant == "shared" else ctc.ctc_dp_global
    loss, gamma = kernel(llp, il, sl, a2)
    ref_loss, ref_gamma = ctc.ctc_dp_plain(llp, p["il"], s_lens, allow2)
    torch.cuda.synchronize()
    if not (torch.equal(loss, ref_loss) and torch.equal(gamma, ref_gamma)):
        raise AssertionError(f"CTC kernel at {[b, t, s]} differs from its "
                             f"plain version")
    nbytes = 2 * llp.numel() * 4 + a2.numel() + 3 * b * 4
    n = cs._n_copies(nbytes)
    llps = [llp.clone() for _ in range(n)]
    row = {"shape": [b, t, s], "variant": variant,
           "ms": cs.device_ms(lambda i: kernel(llps[i], il, sl, a2), n),
           "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3}
    if hasattr(ctc, "chain_step_ms"):
        row["chain_bound_ms"] = t * ctc.chain_step_ms()
    return row


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
                         ("backward", BACKWARD_SHAPES)):
        for b, tp, c, k in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((b, tp, c), generator=gen,
                                device="cuda").to(dtype)
                dy = torch.randn((b, tp - k + 1, c), generator=gen,
                                 device="cuda").to(dtype)
                w = (torch.randn((k, c), generator=gen, device="cuda")
                     * 0.3).to(dtype)
                if kind == "forward":
                    row = cs.kernel_case(b, tp, c, k, dtype, gen)
                    row["copy_ms"] = copy_ms(cs, [x])
                    row["host_us"] = host_us(
                        lambda: dw.depthwise_conv1d(x, w))
                else:
                    row = cs.dwconv_grad_case(b, tp, c, k, dtype, gen)
                    row["copy_ms"] = copy_ms(cs, [dy])
                    row["wgrad_copy_ms"] = copy_ms(cs, [x, dy])
                    row["dgrad_host_us"] = host_us(
                        lambda: dw.depthwise_conv1d_dgrad(dy, w))
                row.update(kind=kind, tree=tree, card=card)
                rows.append(row)
                print(json.dumps(row), flush=True)
    for b, t, l_pad in CTC_SHAPES:
        row = ctc_row(cs, b, t, l_pad, gen)
        row.update(kind="ctc", tree=tree, card=card)
        rows.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "kernel_bench.jsonl"), "a") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
