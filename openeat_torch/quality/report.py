"""Markdown tables of quality drives beside the JAX package's: an lmhard
drive beside round 5's (benchmarks/results/r5_recipe_lmhard/), with the
test CERs and their paired deltas, int8, the adversarial splits, the
per-epoch training curve and the gate's lines; a streamed drive
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
import os
import re
import sys

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
