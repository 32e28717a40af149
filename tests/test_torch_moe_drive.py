"""Drive openeat_torch/quality/run_moe.sh end to end on the CPU: the hard
corpus at 16 / 4 / 8 utterances (run_recipe.sh's stages 0-1), a narrow
MoE Conformer (d 32, 2 blocks, top-2 of 4 experts) for 1 epoch with
--device cpu. Every stage must write its files and results_moe.json
round 3's keys; `confs.py moe` must equal benchmarks/run_moe_hard.sh's
derivation, run with PyYAML on the JAX drive's own hard-profile
conf_synth, and its MoE and schedule keys round 3's conf_moe.yaml;
`results.moe` must rebuild round 3's results_moe.json from its
cer_*.txt; the script must refuse a corpus of another profile and
--device cuda on a machine without a card before any stage; and drive.sh
--script run_moe.sh must stop at a failed stage.
"""

import json
import math
import os
import shutil
import subprocess
import sys

import pytest
import yaml

from openeat_torch.config import load_config
from openeat_torch.quality import confs, report, results
from tests.test_torch_quality_drive import _env, _fail, narrow_conf
from tests.test_torch_streaming_drive import _build_corpus, _heredoc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITY = os.path.join(REPO, "openeat_torch", "quality")
SCRIPT = os.path.join(QUALITY, "run_moe.sh")
BASE = os.path.join(REPO, "examples", "aishell", "conf",
                    "train_conformer_tpu.yaml")
R3 = os.path.join(REPO, "benchmarks", "results", "r3_moe_hard")
MOE_KEYS = ("moe_experts", "moe_top_k", "moe_capacity_factor",
            "moe_aux_weight")


def test_moe_conf_equals_jax_derivation(tmp_path):
    """run_recipe_tpu.sh's hard-profile conf_synth.yaml, then
    run_moe_hard.sh's heredoc on it, with PyYAML: the dict `confs.py moe`
    writes, as load_config reads it back."""
    work = str(tmp_path)
    synth = _heredoc("run_recipe_tpu.sh", "stage 2: train",
                     {"repo_root": REPO, "max_epoch": 60,
                      "train_warmup": 2, "train_lr": 0.0005, "work": work})
    subprocess.run([sys.executable, "-c", synth], check=True)
    moe = _heredoc("run_moe_hard.sh", "train MoE flagship",
                   {"corpus": work, "max_epoch": 60, "warmup_epoch": 8,
                    "work": work})
    subprocess.run([sys.executable, "-c", moe], check=True)
    with open(tmp_path / "conf_moe.yaml") as f:
        jax_conf = yaml.safe_load(f)
    assert confs.moe_train_conf(BASE, 60) == jax_conf
    out = str(tmp_path / "conf_moe.json")
    confs.main(["moe", BASE, "60", out])
    assert load_config(out) == jax_conf
    assert jax_conf["warmup_epoch"] == 8


def test_moe_conf_keys_equal_r3_and_the_moe_yaml():
    """The MoE keys equal train_conformer_moe.yaml's and round 3's
    conf_moe.yaml's; the schedule (warmup 8, 60 epochs, peak lr 5e-4),
    the static batches and SpecAugment equal round 3's, and so does
    every other key but the CTC implementation's name."""
    got = confs.moe_train_conf(BASE, 60)
    with open(os.path.join(R3, "conf_moe.yaml")) as f:
        r3 = yaml.safe_load(f)
    yaml_conf = load_config(os.path.join(REPO, "examples", "aishell",
                                         "conf", "train_conformer_moe.yaml"))
    for key in MOE_KEYS:
        assert got["model_conf"][key] == r3["model_conf"][key] \
            == yaml_conf["model_conf"][key], key
    for key in ("warmup_epoch", "max_epoch", "log_interval"):
        assert got[key] == r3[key], key
    assert got["warmup_epoch"] == 8
    assert got["optim_conf"]["lr"] == r3["optim_conf"]["lr"] == 0.0005
    for key in ("batch_type", "batch_size", "max_length", "min_length",
                "max_frames_in_batch", "sort"):
        assert got["dataset_conf"][key] == r3["dataset_conf"][key], key
    for key in ("spec_aug", "spec_aug_conf", "spec_sub"):
        assert got["collate_conf"][key] == r3["collate_conf"][key], key
    # everything else too, but ctc_impl: the TPU conf moved from native
    # to optax after round 3; the port runs the same CTC kernels for
    # both (only `parallel` differs)
    assert r3["model_conf"].pop("ctc_impl") == "native"
    assert got["model_conf"].pop("ctc_impl") == "optax"
    assert got == r3


def test_results_moe_rebuilds_r3(tmp_path):
    with open(os.path.join(R3, "results_moe.json")) as f:
        r3 = json.load(f)
    for tag in results.MOE_TAGS:
        shutil.copy(os.path.join(R3, f"cer_{tag}.txt"), tmp_path)
    got = results.moe(str(tmp_path))
    assert got == r3 == {"ctc_greedy_search": 9.25,
                         "attention_rescoring": 9.36}
    assert list(got) == list(r3)
    with open(tmp_path / "results_moe.json") as f:
        assert json.load(f) == r3
    out = subprocess.run(
        [sys.executable, "-m", "openeat_torch.quality.results", "moe",
         str(tmp_path)], env=_env(), capture_output=True, text=True,
        check=True).stdout
    assert json.loads(out) == r3


def run(root, *opts, device="cpu", corpus="corpus", work="work"):
    cmd = ["bash", SCRIPT, "--device", device, "--max_epoch", "1",
           "--base_config", narrow_conf(root), *opts, work, corpus]
    return subprocess.run(cmd, cwd=str(root), env=_env(),
                          capture_output=True, text=True, timeout=600)


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe")
    r = _build_corpus(root)
    assert r.returncode == 0, _fail(r)
    return root, run(root)


def test_drive_writes_every_result(drive):
    root, r = drive
    assert r.returncode == 0, _fail(r)
    work = root / "work"
    exp = work / "exp"
    with open(exp / "results_moe.json") as f:
        got = json.load(f)
    with open(os.path.join(R3, "results_moe.json")) as f:
        r3 = json.load(f)
    assert list(got) == list(r3) == results.MOE_TAGS
    for tag in results.MOE_TAGS:
        assert isinstance(got[tag], float) and math.isfinite(got[tag])
    keys = sorted(line.split()[0] for line in
                  open(root / "corpus" / "data" / "test" / "text"))
    for tag in results.MOE_TAGS:
        hyps = (exp / f"hyp_{tag}.txt").read_text().splitlines()
        assert sorted(h.split(" ", 1)[0] for h in hyps) == keys, tag
        assert "Overall" in (exp / f"cer_{tag}.txt").read_text()
    # the derived config: the MoE derivation at the narrow width, trained
    conf = load_config(str(work / "conf_moe.json"))
    assert conf == confs.moe_train_conf(narrow_conf(root), 1)
    trained = load_config(str(exp / "train.json"))
    for key in MOE_KEYS:
        assert trained["model_conf"][key] == confs.MOE_MODEL[key], key
    assert trained["collate_conf"].get("normalization", True) is True
    assert "use_global_cmvn" not in trained or not trained["use_global_cmvn"]
    assert os.path.exists(exp / "avg_best3.pt")
    assert os.path.realpath(work / "data") == str(root / "corpus" / "data")
    recs = [json.loads(line) for line in
            (exp / "metrics.jsonl").read_text().splitlines()]
    epochs = [rec for rec in recs if rec["kind"] == "epoch"]
    assert len(epochs) == 1 and math.isfinite(epochs[0]["train_loss"])
    for rec in recs:
        if rec["kind"] == "train":
            assert math.isfinite(rec["loss"]) and math.isfinite(
                rec["moe_aux"])
    rows = [line.split("\t") for line in
            (work / "stage_times.tsv").read_text().splitlines()]
    assert [(s, label) for s, label, _ in rows] == [
        ("2", "train"), ("3", "average"), ("4", "ctc_greedy_search"),
        ("4", "attention_rescoring"), ("5", "results")]
    assert not os.path.exists(work / "cmvn.json")


def test_rerun_skips_trained_and_scored_work(drive):
    """A second run over the same WORK trains nothing (epoch_1.pt is
    there) and decodes no mode whose cer file exists."""
    root, _ = drive
    shutil.copytree(root / "work", root / "work_rerun", symlinks=True)
    r = run(root, work="work_rerun")
    assert r.returncode == 0, _fail(r)
    rows = [line.split("\t")[:2] for line in
            (root / "work_rerun" / "stage_times.tsv").read_text()
            .splitlines()]
    assert rows[5:] == [["3", "average"], ["5", "results"]]
    assert "stage 2" not in r.stdout


def test_report_sets_the_run_beside_r3(drive, capsys):
    root, _ = drive
    run_dir = root / "report_run"
    run_dir.mkdir()
    for name in ("results_moe.json", "metrics.jsonl", "epoch_1.json"):
        shutil.copy(root / "work" / "exp" / name, run_dir)
    shutil.copy(root / "work" / "stage_times.tsv", run_dir)
    report.main([str(run_dir)])
    out = capsys.readouterr().out
    assert ("| mode | report_run CER % | r3 MoE CER % | r3 dense CER % | "
            "report_run within 0.5 of r3 MoE |") in out
    assert "| 9.25 | 8.78 |" in out and "| 9.36 | 8.84 |" in out
    # r3 aligned at epoch 6 (train_acc 0.435 -> 0.658)
    assert "| r3 | 6 | — | — |" in out
    assert "| 6 | — / — | — / — | — | 13.301 / 0.658 |" in out
    assert "| 2 | — | train " in out
    assert "r5" not in out and "gate" not in out


def test_results_readme_holds_the_report_of_the_committed_run(
        capsys, monkeypatch):
    """openeat_torch/quality/results/h100_moe_hard/README.md's tables are
    what report.py prints for the committed run, whose every logged step
    has a finite loss and router aux loss."""
    root = os.path.join(QUALITY, "results")
    monkeypatch.chdir(root)
    report.main(["h100_moe_hard"])
    out = capsys.readouterr().out.replace("h100_moe_hard:", "run:", 1)
    with open(os.path.join(root, "h100_moe_hard", "README.md"),
              encoding="utf-8") as f:
        assert out in f.read()
    with open(os.path.join(root, "h100_moe_hard", "results_moe.json")) as f:
        got = json.load(f)
    assert list(got) == results.MOE_TAGS
    with open(os.path.join(root, "h100_moe_hard", "metrics.jsonl")) as f:
        steps = [r for r in map(json.loads, f) if r["kind"] == "train"]
    assert steps and all(math.isfinite(r["loss"])
                         and math.isfinite(r["moe_aux"]) for r in steps)


def test_drive_sh_copies_each_stage_and_stops_at_a_failure(drive):
    """drive.sh --script run_moe.sh over stages 1-5 of a copy of the
    trained work dir whose averaged checkpoint's path is a directory:
    stages 1 and 2 (trained already) pass, stage 3 fails and ends the
    drive with its exit code, stage 4 never starts; the small files are
    copied."""
    root, _ = drive
    shutil.copytree(root / "work", root / "work_b", symlinks=True)
    os.remove(root / "work_b" / "exp" / "avg_best3.pt")
    os.mkdir(root / "work_b" / "exp" / "avg_best3.pt")
    out = root / "drive_out"
    r = subprocess.run(
        ["bash", os.path.join(QUALITY, "drive.sh"), "--script",
         "run_moe.sh", "work_b", "corpus", str(out), "1", "5",
         "--device", "cpu", "--max_epoch", "1", "--base_config",
         narrow_conf(root)],
        cwd=str(root), env=_env(), capture_output=True, text=True,
        timeout=600)
    log = (out / "stages.log").read_text()
    assert r.returncode != 0, log[-4000:]
    ends = [(w[2], w[6]) for w in map(str.split, log.splitlines())
            if w[:2] == ["###", "stage"] and w[3] == "end"]
    assert ends == [("1", "0"), ("2", "0"), ("3", str(r.returncode))], \
        log[-4000:]
    assert "### stage 4" not in log
    copied = set(os.listdir(out))
    assert {"cer_ctc_greedy_search.txt", "hyp_attention_rescoring.txt",
            "results_moe.json", "metrics.jsonl", "train.json",
            "epoch_1.json", "conf_moe.json", "stage_times.tsv",
            "stages.log", "machine.txt"} <= copied, sorted(copied)
    assert not [n for n in copied if n.endswith(".pt")]


def test_needs_a_hard_corpus(tmp_path):
    r = run(tmp_path)
    assert r.returncode == 1 and "no hard corpus" in r.stderr
    data = tmp_path / "corpus" / "data"
    (data / "train").mkdir(parents=True)
    (data / "train" / "format.data").write_text("")
    (data / ".corpus_profile").write_text("lmhard\n")
    r = run(tmp_path)
    assert r.returncode == 1
    assert "holds no corpus of the hard profile" in r.stderr
    assert not os.path.exists(tmp_path / "work")


def test_cuda_refused_without_a_card(tmp_path):
    r = run(tmp_path, device="cuda")
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    assert not os.path.exists(tmp_path / "work")
