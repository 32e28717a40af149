"""Readings that a training cell's limits are set from.

    python3 -m perfbench.calibrate --workload NAME --seeds A,B,... \
        [--control_seeds C,D,E] [--out FILE]

For each seed, in one process on the first card: the program's
`check_steps` checked updates as a run takes them (set-up only, no
window), the reference's, the numbers of perfbench/check.py between
them (the lower readings) and the CTC kernels' launches in them. For each control seed also the control (the reference
computed in float8 e4m3, the step below the program's bfloat16) and the
planted fault "half of each micro-batch left out, the mean over the
rest" (the reference so broken, put in the program's place), each
against the reference (the upper readings). One JSON line a seed, to
standard output and appended to FILE.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from perfbench import check, spec
from perfbench.kinds.train import (TrainRun, counts_between, ctc_launches,
                                   kernel_counts)
from perfbench.reference.conformer import Precision


def readings(cell, seed: int, control: bool, device) -> dict:
    t0 = time.perf_counter()
    tr = TrainRun(cell, seed, device)
    before = kernel_counts()
    mine = tr.program_check()
    launches = ctc_launches(counts_between(before, kernel_counts()))
    tr.free_program()
    t1 = time.perf_counter()
    ref = tr.reference(Precision())
    row = {"seed": seed, "program": check.compare(mine, ref),
           "launches": launches, "check_batches": tr.check_idx,
           "worst_leaf": check.worst_leaves(mine, ref),
           "excluded": check.excluded(ref),
           "losses": {"program": mine.losses, "reference": ref.losses},
           "program_s": t1 - t0, "reference_s": time.perf_counter() - t1}
    if control:
        fp8 = tr.reference(Precision(fp8=True))
        row["control_fp8"] = check.compare(fp8, ref)
        half = tr.reference(Precision(), half=True)
        row["fault_half_batch"] = check.compare(half, ref)
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control_seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.calibrate needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(controls - set(seeds)):
        row = readings(cell, seed, seed in controls, device)
        row["workload"] = args.workload
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
