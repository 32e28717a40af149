"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
The configuration's `file` holds its sizes; traffic/<mix>.json its
traffic, whose `kind` names the driver kinds/<kind>.py; limits/<cell>.json
the limits of the numbers that decide `correct`; metrics/<metric>.py the
reader of each per-layer metric. A later cell, mix or metric is new files
plus an entry in BENCHMARK.json.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
ROOT = PACKAGE_DIR.parent
NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
END_TO_END_SOURCES = {"device_trace", "host_clock"}


@dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list[dict] = field(default_factory=list)
    per_layer: list[dict] = field(default_factory=list)


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end metrics, per-layer metrics) that `cell` reports: a
    metric with a `workloads` key in the cells it lists; a per-layer one
    without it in every cell that reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"] if _listed(m, cell)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _listed(m, cell) and m["moves"] in names]
    return e2e, layer


def load_cell(name: str, root: Path = ROOT,
              bench: dict | None = None) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(by_name)}")
    w = by_name[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e, layer = cell_metrics(bench, name)
    return Cell(
        name=name, chips=int(w["chips"]), config_name=cfg["name"],
        config=load_json(root / cfg["file"]), traffic_name=w["traffic"],
        traffic=load_json(root / PACKAGE_DIR.name / "traffic"
                          / f"{w['traffic']}.json"),
        limits=load_json(root / PACKAGE_DIR.name / "limits" / f"{name}.json"),
        end_to_end=e2e, per_layer=layer)


def kind_module(kind: str):
    """The driver of a traffic kind: perfbench/kinds/<kind>.py."""
    if not NAME_RE.fullmatch(kind) or "." in kind:
        raise ValueError(f"bad kind {kind!r}")
    return importlib.import_module(f"perfbench.kinds.{kind}")


def metric_reader(name: str, root: Path = ROOT):
    """`read(ctx) -> float | None` of perfbench/metrics/<name>.py."""
    path = root / PACKAGE_DIR.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _check_text(value, what: str, errors: list) -> None:
    if not isinstance(value, str) or not 1 <= len(value) <= 200 \
            or "\n" in value or "\t" in value:
        errors.append(f"{what}: 1 to 200 characters on one line")


def validate(bench: dict, root: Path = ROOT) -> list[str]:
    """What in `bench` breaks the benchmark's schema (an empty list: all
    holds): the keys, names, units, sources and the files it names."""
    errors: list[str] = []
    pkg = root / PACKAGE_DIR.name
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    if set(bench) != keys:
        errors.append(f"top-level keys {sorted(bench)} != {sorted(keys)}")
        return errors
    if not 1 <= len(bench["paths"]) <= 16:
        errors.append("paths: 1 to 16 directories")
    for p in bench["paths"]:
        if not re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) \
                or p.startswith("/") or ".." in p.split("/"):
            errors.append(f"path {p!r}")
    cmd = bench["command"]
    if not 1 <= len(cmd) <= 32:
        errors.append("command: 1 to 32 words")
    for word in cmd:
        _check_text(word, f"command word {word!r}", errors)
        if word.startswith("/") or ".." in word.split("/"):
            errors.append(f"command word {word!r} leaves the repo")
    if not isinstance(bench["run_seconds"], int) \
            or not 1 <= bench["run_seconds"] <= 51:
        errors.append("run_seconds: a whole number from 1 to 51")
    seen: set[tuple[str, str]] = set()

    def named(entry: dict, allowed: set, what: str) -> None:
        extra = set(entry) - allowed
        if extra:
            errors.append(f"{what} {entry.get('name')!r}: keys {extra}")
        name = entry.get("name", "")
        if not NAME_RE.fullmatch(str(name)):
            errors.append(f"{what} name {name!r}")
        if (what, name) in seen:
            errors.append(f"{what} {name!r} twice")
        seen.add((what, name))

    configs = {}
    for c in bench["configs"]:
        named(c, {"name", "source", "file", "reduced", "why"}, "config")
        configs[c["name"]] = c
        _check_text(c["source"], f"source of {c['name']}", errors)
        _check_text(c["why"], f"why of {c['name']}", errors)
        if not any(c["file"].startswith(p.rstrip("/") + "/")
                   for p in bench["paths"]):
            errors.append(f"config file {c['file']} outside paths")
        elif not (root / c["file"]).is_file():
            errors.append(f"config file {c['file']} missing")
        if len(c["reduced"]) > 16 or not all(
                NAME_RE.fullmatch(k) for k in c["reduced"]):
            errors.append(f"reduced of {c['name']}")
    if not 1 <= len(configs) <= 24:
        errors.append("configs: 1 to 24")
    if not 1 <= len(bench["workloads"]) <= 24:
        errors.append("workloads: 1 to 24")
    pairs = set()
    used = set()
    for w in bench["workloads"]:
        named(w, {"name", "config", "traffic", "chips", "why"}, "workload")
        _check_text(w["why"], f"why of {w['name']}", errors)
        if w["config"] not in configs:
            errors.append(f"workload {w['name']}: no config {w['config']}")
        used.add(w["config"])
        if (w["config"], w["traffic"]) in pairs:
            errors.append(f"workload {w['name']}: pair twice")
        pairs.add((w["config"], w["traffic"]))
        if w["chips"] not in (1, 4):
            errors.append(f"workload {w['name']}: chips 1 or 4")
        if not NAME_RE.fullmatch(w["traffic"]):
            errors.append(f"traffic name {w['traffic']!r}")
        for rel in (f"traffic/{w['traffic']}.json",
                    f"limits/{w['name']}.json"):
            if not (pkg / rel).is_file():
                errors.append(f"workload {w['name']}: {rel} missing")
    if set(configs) - used:
        errors.append(f"configs used by no cell: {set(configs) - used}")
    cells = {w["name"] for w in bench["workloads"]}
    for what, metrics, lo, hi in (("end_to_end", bench["end_to_end"], 1, 16),
                                  ("per_layer", bench["per_layer"], 1, 128)):
        if not lo <= len(metrics) <= hi:
            errors.append(f"{what}: {lo} to {hi} metrics")
        for m in metrics:
            allowed = {"name", "unit", "better", "source", "workloads"}
            allowed |= ({"bound"} if what == "end_to_end"
                        else {"layer", "moves"})
            named(m, allowed, "metric")
            if not UNIT_RE.fullmatch(str(m.get("unit", ""))):
                errors.append(f"unit of {m['name']}")
            if m.get("better") not in ("lower", "higher"):
                errors.append(f"better of {m['name']}")
            ok = END_TO_END_SOURCES if what == "end_to_end" else SOURCES
            if m.get("source") not in ok:
                errors.append(f"source of {m['name']}")
            if not set(m.get("workloads", [])) <= cells:
                errors.append(f"workloads of {m['name']}")
            if what == "end_to_end":
                b = m.get("bound")
                if not isinstance(b, (int, float)) or not 0.01 <= b <= 0.25:
                    errors.append(f"bound of {m['name']}")
            else:
                _check_text(m.get("layer"), f"layer of {m['name']}", errors)
                if not (pkg / "metrics" / f"{m['name']}.py").is_file():
                    errors.append(f"no reader metrics/{m['name']}.py")
    e2e = {m["name"] for m in bench["end_to_end"]}
    if "setup_s" not in e2e:
        errors.append("no setup_s")
    for m in bench["per_layer"]:
        if m.get("moves") not in e2e:
            errors.append(f"{m['name']} moves {m.get('moves')!r}")
    for w in bench["workloads"]:
        mine, layer = cell_metrics(bench, w["name"])
        names = {m["name"] for m in mine}
        if "setup_s" not in names or len(names) < 2 or not layer:
            errors.append(f"cell {w['name']}: setup_s, another end-to-end "
                          f"metric and a per-layer metric")
    return errors
