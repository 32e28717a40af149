"""BENCHMARK.json against the schema, and a new cell, mix, config and
metric added by new files and entries alone."""

import json
import shutil

from perfbench import check, spec


def test_benchmark_meets_the_schema():
    assert spec.validate(spec.load_benchmark()) == []


def test_every_cell_loads_with_its_files():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], bench=bench)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert spec.kind_module(cell.traffic["kind"]).run
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
        assert set(cell.limits["limits"]) <= set(check.NUMBERS)
        assert cell.limits["at_least"] == {"ctc_shared_launches": 1,
                                           "ctc_global_launches": 1}
        assert cell.limits["check_steps"] >= 3


def test_names_and_units():
    bench = spec.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert spec.NAME_RE.fullmatch(m["name"])
        assert spec.UNIT_RE.fullmatch(m["unit"])
    for m in bench["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
            assert m["unit"] == "%"


def test_a_dummy_cell_is_new_files_and_entries(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    cell and a per-layer metric by adding files and BENCHMARK.json
    entries; no file that was there changes."""
    root = tmp_path / "tree"
    shutil.copytree(spec.PACKAGE_DIR, root / "perfbench")
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    pkg = root / "perfbench"
    cfg = json.loads((pkg / "configs/aishell_conformer.json").read_text())
    cfg["name"] = "dummy_conformer"
    (pkg / "configs/dummy_conformer.json").write_text(json.dumps(cfg))
    (pkg / "traffic/dummy_mix.json").write_text(json.dumps(
        {"kind": "train", "pool_seed": 1, "pool_utterances": 8,
         "epoch_utterances": 40,
         "duration_s": {"mean": 2.0, "sigma": 0.2, "min": 1.0, "max": 3.0},
         "units_per_s": 3.0}))
    (pkg / "limits/dummy_cell.json").write_text(json.dumps(
        {"check_steps": 3, "limits": {"loss_gap": 0.1}}))
    (pkg / "metrics/dummy.ratio.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy_conformer", "source":
                             "https://example.org/dummy", "file":
                             "perfbench/configs/dummy_conformer.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy_cell", "config":
                               "dummy_conformer", "traffic": "dummy_mix",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("dummy_cell")
    bench["per_layer"].append({"name": "dummy.ratio", "unit": "%",
                               "better": "higher", "source":
                               "program_counter", "layer": "device",
                               "moves": "train_audio_s_per_s",
                               "workloads": ["dummy_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert spec.validate(bench, root) == []
    cell = spec.load_cell("dummy_cell", root=root, bench=bench)
    assert cell.config["name"] == "dummy_conformer"
    assert cell.traffic["pool_utterances"] == 8
    assert [m["name"] for m in cell.per_layer][-1] == "dummy.ratio"
    assert spec.metric_reader("dummy.ratio", root)(None) == 1.0
    changed = [p for p, b in before.items() if p.read_bytes() != b
               and p.name != "BENCHMARK.json"]
    assert changed == []


def test_validate_catches_breaches():
    bench = spec.load_benchmark()
    bad = json.loads(json.dumps(bench))
    bad["end_to_end"][0]["bound"] = 0.5
    bad["workloads"][0]["chips"] = 2
    bad["per_layer"][0]["moves"] = "nothing"
    bad["per_layer"][1]["why"] = "a key the schema has not"
    errors = spec.validate(bad)
    assert any("bound" in e for e in errors)
    assert any("chips" in e for e in errors)
    assert any("moves" in e for e in errors)
    assert any("keys" in e for e in errors)
