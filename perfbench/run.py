"""One run of one benchmark cell.

    python3 -m perfbench.run --workload NAME --seed N --seconds S --trace 0|1

Needs as many CUDA cards as the cell asks for and exits 2 without them,
printing no result. Set-up (corpus, weights, the program's objects, the
updates the check follows, the warm-up) counts from the process's start
to the first timed batch; then the window of S seconds; then the
comparison with the plain reference. The last line of standard output is
the result: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with --trace 0, its per-layer ones with --trace 1),
`device` and, traced, `breakdown`; the numbers compared come last, under
`check`, and again as the last lines of standard error. A process that
holds jax, jaxlib, flax or openeat_tpu once the window has closed exits
3 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "openeat_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: openeat_torch is not openeat_tpu."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=20).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def run_cell(cell, seed: int, seconds: float, tracing: bool, device,
             t_start: float = T_START, cache_root=None) -> dict:
    """The result of one run on `device` (the CLI passes the first card;
    a test may pass the CPU): the dict printed as the last line."""
    from perfbench import check, spec
    out = spec.kind_module(cell.traffic["kind"]).run(
        cell, seed, seconds, tracing, device, t_start, cache_root)
    correct, table = check.judge(out["numbers"], cell.limits["limits"],
                                 cell.limits.get("at_least"))
    metrics = {}
    if tracing:
        ctx = out["context"]
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = out["end_to_end"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (_device_name(device)), "count": cell.chips,
                   "memory_peak_bytes": int(out["memory_peak_bytes"]),
                   "power_limit_w": power_limit_w()
                   if device.type == "cuda" else None}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": device_info}
    trace = out["context"].trace
    if tracing and trace is not None:
        device_info["busy_s"] = trace.busy_s()
        device_info["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_ops(10),
                               "idle_gaps": trace.idle_gaps(10)}
    result["notes"] = out.get("notes", {})
    result["check"] = table
    return result


def _device_name(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    from perfbench import spec
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); found {n}", file=sys.stderr)
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process holds {bad}", file=sys.stderr)
        return 3
    for name, row in result["check"].items():
        bound = (f"limit {row['limit']!r}" if "limit" in row
                 else f"at least {row['at_least']!r}")
        print(f"check {name} {row['value']!r} {bound}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_plain(result), allow_nan=False))
    return 0


def _plain(x):
    """The result with every non-finite number as null (strict JSON)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


if __name__ == "__main__":
    sys.exit(main())
