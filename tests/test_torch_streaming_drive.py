"""Drive openeat_torch/quality/run_streaming.sh end to end on the CPU: the
hard corpus at 16 / 4 / 8 utterances (run_recipe.sh's stages 0-1), a
narrow causal Conformer (d 32, 2 blocks) for 2 epochs with --device cpu.
Every stage must write its files and results_streaming.json round 3's
keys; `confs.py stream` must equal benchmarks/run_streaming_hard.sh's
derivation, run with PyYAML on the JAX drive's own hard-profile
conf_synth; `results.streaming` must rebuild round 3's CER fields from
its cer_*.txt; --device cuda must refuse on a machine without a card
before any stage; and drive.sh --script run_streaming.sh must stop at a
failed stage.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import yaml

from openeat_torch.config import load_config
from openeat_torch.quality import confs, report, results
from tests.test_torch_quality_drive import _env, _fail, narrow_conf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITY = os.path.join(REPO, "openeat_torch", "quality")
SCRIPT = os.path.join(QUALITY, "run_streaming.sh")
BASE = os.path.join(REPO, "examples", "aishell", "conf",
                    "train_conformer_tpu.yaml")
R3 = os.path.join(REPO, "benchmarks", "results", "r3_streaming_hard")
CORPUS_OPTS = "--n_train 16 --n_dev 4 --n_test 8"


def _heredoc(script: str, after: str, values: dict) -> str:
    """The first `python - <<PY` heredoc of benchmarks/SCRIPT after the
    line holding `after`, with its $names replaced from `values`."""
    with open(os.path.join(REPO, "benchmarks", script)) as f:
        text = f.read()
    start = text.index("python - <<PY\n", text.index(after))
    body = text[start:].split("\n", 1)[1]
    body = body[:body.index("\nPY\n")]
    return re.sub(r"\$(\w+)", lambda m: str(values[m[1]]), body)


def test_stream_conf_equals_jax_derivation(tmp_path):
    """run_recipe_tpu.sh's hard-profile conf_synth.yaml, then
    run_streaming_hard.sh's heredoc on it, with PyYAML: the dict
    `confs.py stream` writes, as load_config reads it back."""
    work = str(tmp_path)
    synth = _heredoc("run_recipe_tpu.sh", "stage 2: train",
                     {"repo_root": REPO, "max_epoch": 60,
                      "train_warmup": 2, "train_lr": 0.0005, "work": work})
    subprocess.run([sys.executable, "-c", synth], check=True)
    stream = _heredoc("run_streaming_hard.sh", "train causal static-chunk",
                      {"corpus": work, "max_epoch": 40, "work": work})
    subprocess.run([sys.executable, "-c", stream], check=True)
    with open(tmp_path / "conf_stream.yaml") as f:
        jax_conf = yaml.safe_load(f)
    assert confs.stream_train_conf(BASE, 40) == jax_conf
    out = str(tmp_path / "conf_stream.json")
    confs.main(["stream", BASE, "40", out])
    assert load_config(out) == jax_conf
    assert jax_conf["model_conf"]["causal"] is True
    assert jax_conf["warmup_epoch"] == 8


def test_results_streaming_rebuilds_r3(tmp_path, monkeypatch):
    """Round 3's CER fields from its cer_*.txt; the comparison is
    compare_wer's, whose hypothesis files round 3 did not keep."""
    with open(os.path.join(R3, "results_streaming.json")) as f:
        r3 = json.load(f)
    for tag in results.STREAM_TAGS:
        shutil.copy(os.path.join(R3, f"cer_{tag}.txt"), tmp_path)
    name, a, b = results.STREAM_PAIR
    calls = []

    def compare(ref, hyp_a, hyp_b):
        calls.append((ref, hyp_a, hyp_b))
        return r3[name]

    monkeypatch.setattr(results, "compare", compare)
    got = results.streaming(str(tmp_path), "REF")
    assert got == r3
    assert calls == [("REF", str(tmp_path / f"hyp_{a}.txt"),
                      str(tmp_path / f"hyp_{b}.txt"))]
    with open(tmp_path / "results_streaming.json") as f:
        assert json.load(f) == r3


def _build_corpus(root) -> subprocess.CompletedProcess:
    return subprocess.run(
        ["bash", os.path.join(QUALITY, "run_recipe.sh"), "--device", "cpu",
         "--stage", "0", "--stop_stage", "1", "--corpus_opts", CORPUS_OPTS,
         "corpus", "hard"], cwd=str(root), env=_env(), capture_output=True,
        text=True, timeout=600)


def run(root, *opts, device="cpu", corpus="corpus"):
    cmd = ["bash", SCRIPT, "--device", device, "--max_epoch", "2",
           "--base_config", narrow_conf(root), *opts, "work", corpus]
    return subprocess.run(cmd, cwd=str(root), env=_env(),
                          capture_output=True, text=True, timeout=600)


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    root = tmp_path_factory.mktemp("streaming")
    r = _build_corpus(root)
    assert r.returncode == 0, _fail(r)
    return root, run(root)


def test_drive_writes_every_result(drive):
    root, r = drive
    assert r.returncode == 0, _fail(r)
    work = root / "work"
    exp = work / "exp"
    with open(exp / "results_streaming.json") as f:
        got = json.load(f)
    with open(os.path.join(R3, "results_streaming.json")) as f:
        r3 = json.load(f)
    assert list(got) == list(r3)
    name = results.STREAM_PAIR[0]
    assert list(got[name]) == list(r3[name])
    assert got[name]["utts"] == 8
    for tag in results.STREAM_TAGS:
        assert isinstance(got[tag], float) and got[tag] >= 0.0
    keys = sorted(line.split()[0] for line in
                  open(root / "corpus" / "data" / "test" / "text"))
    for tag in results.STREAM_TAGS:
        hyps = (exp / f"hyp_{tag}.txt").read_text().splitlines()
        assert sorted(h.split(" ", 1)[0] for h in hyps) == keys, tag
    # the derived config: the stream derivation at the narrow width
    conf = load_config(str(work / "conf_stream.json"))
    assert conf == confs.stream_train_conf(narrow_conf(root), 2)
    assert conf["model_conf"]["static_chunk_size"] == 16
    trained = load_config(str(exp / "train.json"))
    assert trained["use_global_cmvn"] is True
    assert trained["collate_conf"]["normalization"] is False
    assert "frame_num" in json.loads((work / "cmvn.json").read_text())
    assert os.path.realpath(work / "data") == str(root / "corpus" / "data")
    rows = [line.split("\t") for line in
            (work / "stage_times.tsv").read_text().splitlines()]
    assert [(s, label) for s, label, _ in rows] == [
        ("1", "cmvn"), ("2", "train"), ("3", "average"),
        ("4", "offline_ctc_greedy_search"),
        ("4", "offline_attention_rescoring"), ("5", "streamed"),
        ("6", "results")]
    assert "over 16 slots" in r.stderr


def test_report_sets_the_run_beside_r3(drive, capsys):
    root, _ = drive
    report.main([str(root / "work" / "exp")])
    out = capsys.readouterr().out
    assert "| decode | exp CER % | r3 CER % |" in out
    assert "| offline_attention_rescoring | " in out and "| 6.00 |" in out
    assert "+0.018 [-0.005, 0.045], p=0.8943 |" in out
    assert "r5" not in out and "gate" not in out


def test_results_readme_holds_the_report_of_the_committed_run(
        capsys, monkeypatch):
    """openeat_torch/quality/results/h100_streaming_hard/README.md's
    tables are what report.py prints for the committed run, whose
    streamed decode is not significantly worse than offline rescoring
    over r3's test set."""
    root = os.path.join(QUALITY, "results")
    monkeypatch.chdir(root)
    report.main(["h100_streaming_hard"])
    out = capsys.readouterr().out.replace("h100_streaming_hard:", "run:", 1)
    with open(os.path.join(root, "h100_streaming_hard", "README.md"),
              encoding="utf-8") as f:
        assert out in f.read()
    with open(os.path.join(root, "h100_streaming_hard",
                           "results_streaming.json")) as f:
        got = json.load(f)
    cmp = got[results.STREAM_PAIR[0]]
    assert cmp["utts"] == 2048 and cmp["tokens"] == 22364
    assert cmp["delta_ci95"][0] <= 0.0


def test_drive_sh_copies_each_stage_and_stops_at_a_failure(drive):
    """drive.sh --script run_streaming.sh over stages 4-6 of a copy of
    the trained work dir without its averaged checkpoint: stage 4 keeps
    its scored decodes, stage 5 fails and ends the drive with its exit
    code, stage 6 never starts; the small files are copied."""
    root, _ = drive
    shutil.copytree(root / "work", root / "work_b", symlinks=True)
    os.remove(root / "work_b" / "exp" / "avg_best3.pt")
    out = root / "drive_out"
    r = subprocess.run(
        ["bash", os.path.join(QUALITY, "drive.sh"), "--script",
         "run_streaming.sh", "work_b", "corpus", str(out), "4", "6",
         "--device", "cpu", "--max_epoch", "2", "--base_config",
         narrow_conf(root)],
        cwd=str(root), env=_env(), capture_output=True, text=True,
        timeout=600)
    log = (out / "stages.log").read_text()
    assert r.returncode != 0, log[-4000:]
    ends = [(w[2], w[6]) for w in map(str.split, log.splitlines())
            if w[:2] == ["###", "stage"] and w[3] == "end"]
    assert [s for s, _ in ends] == ["4", "5"] and ends[0][1] == "0" \
        and ends[1][1] == str(r.returncode), log[-4000:]
    assert "### stage 6" not in log
    copied = set(os.listdir(out))
    assert {"cer_offline_ctc_greedy_search.txt",
            "hyp_offline_attention_rescoring.txt", "metrics.jsonl",
            "train.json", "epoch_2.json", "conf_stream.json", "cmvn.json",
            "stage_times.tsv", "stages.log", "machine.txt"} <= copied, \
        sorted(copied)
    assert not [n for n in copied if n.endswith(".pt")]


def test_needs_a_hard_corpus(tmp_path):
    r = run(tmp_path)
    assert r.returncode == 1 and "no hard corpus" in r.stderr
    assert not os.path.exists(tmp_path / "work")


def test_cuda_refused_without_a_card(tmp_path):
    r = run(tmp_path, device="cuda")
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    assert not os.path.exists(tmp_path / "work")
