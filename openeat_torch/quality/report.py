"""Markdown tables of quality drives beside the JAX package's: an lmhard
drive beside round 5's (benchmarks/results/r5_recipe_lmhard/), with the
test CERs and their paired deltas, int8, the adversarial splits, the
per-epoch training curve and the gate's lines, and, when a run started
from flax's initial weights, one row a draw (`draws`: the initializer
and seed, the early gap to r5, the alignment epoch, the gate) with the
exact permutation chance that the port's draws train more slowly than
flax's; a streamed drive
(run_streaming.sh, whose RUN holds results_streaming.json) beside round
3's (benchmarks/results/r3_streaming_hard/), with its three CERs, the
paired comparison of streamed against offline rescoring and its curve;
a MoE drive (run_moe.sh, whose RUN holds results_moe.json) beside round
3's MoE and dense drives (benchmarks/results/r3_moe_hard/,
r3_recipe_hard/), with its two CERs, its curve beside r3's MoE curve,
each run's alignment epoch and its router's aux loss. Each stage's
seconds for any; a column (or a block of rows) per run.

    python -m openeat_torch.quality.report RUN [RUN ...]

Each RUN is a directory openeat_torch/quality/drive.sh copied a drive's
small files into; it is named by its last path component. The RUNs of
one call are all lmhard drives, all streamed drives or all MoE drives.
"""

from __future__ import annotations

import json
import math
import os
import re
import sys
from fractions import Fraction
from itertools import combinations

from openeat_torch.quality import results as res

RESULTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "benchmarks", "results")
R5 = os.path.join(RESULTS, "r5_recipe_lmhard")
R3_STREAMING = os.path.join(RESULTS, "r3_streaming_hard")
R3_MOE = os.path.join(RESULTS, "r3_moe_hard")
R3_DENSE = os.path.join(RESULTS, "r3_recipe_hard")
STREAMING = "results_streaming.json"
# the MoE drive's band: each CER within this of r3's MoE drive
MOE_BAND = 0.5
# train_acc past this marks CTC alignment
ALIGNED_ACC = 0.6
# the committed lmhard runs that are one initial draw each, beside the
# run_drawSEED (the port's init_parameters) and run_flaxSEED (flax's
# init_params) runs: {run name: (initializer, seed)}; run_b is run_a's
# draw again and ran no stage 8
DRAW_RUNS = {"run_a": ("port", 777), "run_flax_init": ("flax", 777)}
DRAW_NAME = re.compile(r"run_(draw|flax)(\d+)$")
# the epochs whose train loss against r5's measures a draw's early gap
GAP_EPOCHS = (2, 3, 4, 5)
# the paired comparison whose delta each CER row shows
PAIR_OF = {"ctc_prefix_beam_search": "greedy_vs_prefix",
           "attention_rescoring": "greedy_vs_rescoring",
           "rescoring_ngram": "rescoring_vs_ngram_fusion",
           "rescoring_translm": "rescoring_vs_translm_fusion"}


def _load(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _epochs(run: str) -> dict:
    """{epoch: the epoch record} of a run's metrics.jsonl."""
    path = os.path.join(run, "metrics.jsonl")
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        recs = [json.loads(line) for line in f]
    return {r["epoch"]: r for r in recs if r.get("kind") == "epoch"}


def _f(x, fmt="{:.2f}") -> str:
    return "—" if x is None else fmt.format(x)


def _delta(cmp: dict | None) -> str:
    if not cmp:
        return "—"
    lo, hi = cmp["delta_ci95"]
    return (f"{cmp['delta']:+.3f} [{lo:.3f}, {hi:.3f}], "
            f"p={cmp['p_a_worse_bootstrap']}")


def _table(head: list[str], rows: list[list[str]]) -> list[str]:
    return (["| " + " | ".join(head) + " |", "|" + "---|" * len(head)]
            + ["| " + " | ".join(r) + " |" for r in rows])


def cers(runs: list[str], names: list[str]) -> list[str]:
    """Each mode's test CER and paired delta (A - B of its pair: greedy
    against prefix and rescoring, rescoring against each fusion) per run
    and in r5."""
    dirs = runs + [R5]
    got = [{**_load(os.path.join(d, "results.json")),
            **_load(os.path.join(d, "results_lm.json"))} for d in dirs]
    sig = [_load(os.path.join(d, "results_significance.json"))
           for d in dirs]
    rows = []
    for tag in res.MODES + res.LM_TAGS:
        pair = PAIR_OF.get(tag)
        rows.append([tag] + [_f(g.get(tag)) for g in got]
                    + [_delta(s.get(pair)) if pair else "—" for s in sig])
    head = (["mode"] + [f"{n} CER %" for n in names + ["r5"]]
            + [f"{n} paired delta" for n in names + ["r5"]])
    lines = _table(head, rows)
    for name, run, g in zip(names, runs, got):
        int8 = _load(os.path.join(run, "results_int8.json"))
        if int8:
            lines.append(f"\n{name}: int8 attention rescoring "
                         f"{_f(int8[res.INT8_TAG])} % (float "
                         f"{_f(g.get('attention_rescoring'))}); float vs "
                         f"int8 {_delta(int8['rescoring_vs_int8'])}")
    return lines


def adversarial(runs: list[str], names: list[str]) -> list[str]:
    got = [_load(os.path.join(d, "results_adversarial.json"))
           for d in runs + [R5]]
    pair = {"attention_rescoring": "greedy_vs_rescoring",
            "rescoring_ngram": "rescoring_vs_ngram_fusion"}
    rows = []
    for split in res.ADVERSARIAL_SPLITS:
        for tag in res.ADVERSARIAL_TAGS:
            name = pair.get(tag)
            rows.append([split, tag]
                        + [_f(g.get(split, {}).get(tag)) for g in got]
                        + [_delta(g.get(split, {}).get(name)) if name
                           else "—" for g in got])
    head = (["split", "mode"] + [f"{n} CER %" for n in names + ["r5"]]
            + [f"{n} paired delta" for n in names + ["r5"]])
    return _table(head, rows)


def streaming(runs: list[str], names: list[str]) -> list[str]:
    """The streamed drive's three CERs per run and in r3, and each one's
    paired comparison of streamed against offline rescoring."""
    got = [_load(os.path.join(d, STREAMING)) for d in runs + [R3_STREAMING]]
    name = res.STREAM_PAIR[0]
    rows = [[tag] + [_f(g.get(tag)) for g in got]
            for tag in res.STREAM_TAGS]
    rows.append([name] + [_delta(g.get(name)) for g in got])
    return _table(["decode"] + [f"{n} CER %" for n in names + ["r3"]], rows)


def curve(runs: list[str], names: list[str], ref: str | None = R5,
          ref_name: str = "r5") -> list[str]:
    """train_loss / train_acc an epoch per run and in `ref`'s
    metrics.jsonl (r5's; None for none); cv_loss / cv_acc (from the
    epoch infos) and the epoch's seconds per run."""
    refs = [ref] if ref else []
    eps = [_epochs(d) for d in runs + refs]
    rows = []
    for e in sorted(set().union(*eps)):
        row = [str(e)]
        for d, ep in zip(runs + refs, eps):
            r = ep.get(e, {})
            row.append(f"{_f(r.get('train_loss'), '{:.3f}')} / "
                       f"{_f(r.get('train_acc'), '{:.3f}')}")
            if d != ref:
                info = _load(os.path.join(d, f"epoch_{e + 1}.json"))
                row.append(f"{_f(info.get('cv_loss'), '{:.3f}')} / "
                           f"{_f(info.get('cv_acc'), '{:.3f}')}")
                row.append(_f(r.get("epoch_time_s"), "{:.1f}"))
        rows.append(row)
    head = ["epoch"]
    for n in names:
        head += [f"{n} train loss / acc", f"{n} cv loss / acc", f"{n} s"]
    return _table(head + [f"{ref_name} train loss / acc"] * len(refs),
                  rows)


def moe(runs: list[str], names: list[str]) -> list[str]:
    """The MoE drive's two CERs per run beside r3's MoE and dense ones,
    and whether each lies within MOE_BAND of r3's MoE CER."""
    got = [_load(os.path.join(d, res.MOE)) for d in runs]
    r3 = _load(os.path.join(R3_MOE, res.MOE))
    dense = _load(os.path.join(R3_DENSE, "results.json"))
    rows = []
    for tag in res.MOE_TAGS:
        band = [("yes" if abs(g[tag] - r3[tag]) <= MOE_BAND else "no")
                if g.get(tag) is not None else "—" for g in got]
        rows.append([tag] + [_f(g.get(tag)) for g in got]
                    + [_f(r3[tag]), _f(dense[tag])] + band)
    head = (["mode"] + [f"{n} CER %" for n in names]
            + ["r3 MoE CER %", "r3 dense CER %"]
            + [f"{n} within {MOE_BAND} of r3 MoE" for n in names])
    return _table(head, rows)


def aligned_epoch(run: str) -> int | None:
    """The first epoch whose train_acc passes ALIGNED_ACC."""
    eps = _epochs(run)
    return next((e for e in sorted(eps)
                 if eps[e]["train_acc"] > ALIGNED_ACC), None)


def draw_of(name: str) -> tuple[str, int] | None:
    """(initializer, seed) of a run named as one draw, else None."""
    if name in DRAW_RUNS:
        return DRAW_RUNS[name]
    m = DRAW_NAME.match(name)
    return ("port" if m[1] == "draw" else "flax", int(m[2])) if m else None


def draw_row(run: str, name: str, ref: str = R5) -> dict:
    """One draw's row: its train loss above `ref`'s in GAP_EPOCHS and
    their mean, its alignment epoch and its gate (stage 8's line, and
    rescoring - greedy from results.json). A run without stage 8 is no
    draw's row."""
    draw = draw_of(name)
    if draw is None:
        raise ValueError(f"{name} is not named as one draw")
    gate = gate_lines(run)
    if not gate:
        raise ValueError(f"{name}: stage 8 did not run, so it gives no "
                         "draw's row")
    eps, ref_eps = _epochs(run), _epochs(ref)
    gaps = [eps[e]["train_loss"] - ref_eps[e]["train_loss"]
            for e in GAP_EPOCHS]
    got = _load(os.path.join(run, "results.json"))
    return {"name": name, "init": draw[0], "seed": draw[1], "gaps": gaps,
            "mean_gap": sum(gaps) / len(gaps),
            "aligned": aligned_epoch(run),
            "margin": got["attention_rescoring"] - got["ctc_greedy_search"],
            "gate": "PASS" if gate[-1].startswith("QUALITY_GATE PASS")
            else "FAIL"}


def permutation_chance(port: list[float], flax: list[float]) -> Fraction:
    """One-sided exact permutation chance that the port's draws lie above
    flax's: over every split of the pooled values into groups of the two
    sizes, the share whose first group's mean minus the second's is at
    least the observed one. Ties count as at least as extreme, that is
    against the claim."""
    pool = list(port) + list(flax)
    k, n = len(port), len(pool)

    def stat(first):
        rest = [pool[i] for i in range(n) if i not in first]
        return (sum(pool[i] for i in first) / k - sum(rest) / (n - k))

    observed = stat(range(k))
    splits = list(combinations(range(n), k))
    hits = sum(stat(first) >= observed - 1e-9 for first in splits)
    return Fraction(hits, len(splits))


def draws(runs: list[str], names: list[str], ref: str = R5) -> list[str]:
    """A row a draw (draw_row) and, below, the exact one-sided
    permutation chances (permutation_chance) that the port's draws have
    the larger mean gap and the later alignment epoch than flax's."""
    rows = [draw_row(run, name, ref) for run, name in zip(runs, names)]
    lines = _table(
        ["run", "initializer", "seed", "epochs 2-5 above r5", "mean",
         f"aligned (train_acc > {ALIGNED_ACC}) at epoch",
         "rescoring - greedy", "gate"],
        [[r["name"], r["init"], str(r["seed"]),
          " / ".join(f"{g:+.2f}" for g in r["gaps"]),
          f"{r['mean_gap']:+.3f}", _f(r["aligned"], "{}"),
          f"{r['margin']:+.2f}", r["gate"]] for r in rows])
    port = [r for r in rows if r["init"] == "port"]
    flax = [r for r in rows if r["init"] == "flax"]
    if port and flax:
        n, k = len(rows), len(port)
        splits = math.comb(n, k)
        lines.append(
            f"\nExact one-sided permutation chance over the C({n},{k}) = "
            f"{splits} splits of the {n} draws into groups of {k} and "
            f"{n - k}, ties counted against the claim that the port's "
            "draws train more slowly:")
        for label, key in (("mean gap in epochs 2-5 (port above flax)",
                            "mean_gap"),
                           ("alignment epoch (port later than flax)",
                            "aligned")):
            p = permutation_chance([r[key] for r in port],
                                   [r[key] for r in flax])
            lines.append(f"- {label}: {int(p * splits)}/{splits} = "
                         f"{float(p):.3f}")
    return lines


def moe_router(runs: list[str], names: list[str]) -> list[str]:
    """Each run's alignment epoch and its router aux loss (`moe_aux`) at
    the first and last logged step; r3's alignment epoch (its
    metrics.jsonl logs no aux loss)."""
    rows = []
    for name, run in zip(names, runs):
        with open(os.path.join(run, "metrics.jsonl"),
                  encoding="utf-8") as f:
            steps = [r for r in map(json.loads, f) if r["kind"] == "train"]
        aux = [f"{_f(r.get('moe_aux'), '{:.4f}')} (step {r['step']})"
               for r in steps[:1] + steps[-1:]] or ["—", "—"]
        rows.append([name, _f(aligned_epoch(run), "{}"), aux[0], aux[-1]])
    rows.append(["r3", _f(aligned_epoch(R3_MOE), "{}"), "—", "—"])
    return _table(["run", f"aligned (train_acc > {ALIGNED_ACC}) at epoch",
                   "moe_aux first", "moe_aux last"], rows)


def stages(run: str) -> list[str]:
    """Each stage's seconds (drive.sh's stamps in stages.log) and its
    commands' (run_recipe.sh's stage_times.tsv)."""
    spans, cmds = {}, {}
    log = os.path.join(run, "stages.log")
    if os.path.exists(log):
        for line in open(log, encoding="utf-8"):
            m = re.match(r"### stage (\d+) (start|end) (\S+)", line)
            if m:
                spans.setdefault(int(m[1]), {})[m[2]] = float(m[3])
    tsv = os.path.join(run, "stage_times.tsv")
    if os.path.exists(tsv):
        for line in open(tsv, encoding="utf-8"):
            stage, label, secs = line.rstrip("\n").split("\t")
            cmds.setdefault(int(stage), []).append(f"{label} {secs}")
    rows = []
    for s in sorted(set(spans) | set(cmds)):
        span = spans.get(s, {})
        secs = (f"{span['end'] - span['start']:.1f}"
                if {"start", "end"} <= set(span) else "—")
        rows.append([str(s), secs, ", ".join(cmds.get(s, []))])
    return _table(["stage", "seconds", "commands (seconds)"], rows)


def gate_lines(run: str) -> list[str]:
    log = os.path.join(run, "stages.log")
    if not os.path.exists(log):
        return []
    return [line.rstrip("\n") for line in open(log, encoding="utf-8")
            if line.startswith("QUALITY_GATE")]


def main(argv=None):
    runs = sys.argv[1:] if argv is None else argv
    names = [os.path.basename(os.path.normpath(r)) for r in runs]
    for name, run in zip(names, runs):
        machine = os.path.join(run, "machine.txt")
        if os.path.exists(machine):
            print(f"{name}:\n\n```\n{open(machine).read().strip()}\n```\n")
    streamed = all(os.path.exists(os.path.join(r, STREAMING)) for r in runs)
    routed = all(os.path.exists(os.path.join(r, res.MOE)) for r in runs)
    if routed:
        tables = (("MoE against r3's MoE and dense drives (test set)",
                   moe),
                  ("Alignment and router aux loss", moe_router),
                  ("Training curve",
                   lambda r, n: curve(r, n, ref=R3_MOE, ref_name="r3")))
    elif streamed:
        tables = (("Streamed against offline (test set)", streaming),
                  ("Training curve",
                   lambda r, n: curve(r, n, ref=None)))
    else:
        tables = (("Test CERs (2048 utterances)", cers),
                  ("Adversarial splits (1024 utterances each)",
                   adversarial),
                  ("Training curve", curve))
        if any((draw_of(n) or ("",))[0] == "flax" for n in names):
            tables += (("Draws", draws),)
    for title, body in tables:
        print(f"### {title}\n\n" + "\n".join(body(runs, names)) + "\n")
    for name, run in zip(names, runs):
        if not (streamed or routed):
            gate = gate_lines(run) or ["(stage 8 did not run)"]
            print(f"### {name}: gate\n\n```\n" + "\n".join(gate)
                  + "\n```\n")
        print(f"### {name}: stage seconds\n\n" + "\n".join(stages(run))
              + "\n")


if __name__ == "__main__":
    main()
