"""openeat_torch/quality/init_draw.py, the port's own initial weights as
an epoch-0 checkpoint, and the port's initializers against flax's at
the lmhard drive's full width.

- The writer's draw at a seed equals, bit for bit, the model
  `bin.train` builds for itself at that seed (its state after
  `--max_epoch 0`); its printed sha256 does not change between calls;
  `bin.train --checkpoint OUT/epoch_0.pt` starts from it at epoch 0 and
  step 0 with a fresh optimizer and the schedule's first lr; the module
  imports no jax and nothing of openeat_tpu; `--per_tensor` writes one
  sha256 a tensor and `--against` groups the differing ones by the
  in-place calls that drew them. The committed card runs from the
  port's draws at 778 and 779 started from the writer's file, those
  from flax's draws at 778 and 779 from the flax writer's, and their
  README holds report.py's tables over them.
- At the drive's width (run_a's train.json: d 256, 12 blocks, FFN 1024,
  3 + 3 decoders, vocab 54), flax's draw at PRNGKey(777) (the initial
  weights of run_flax_init) and the port's at make_generator(777)
  (run_a's), for every non-constant tensor of n elements: the
  two-sample Kolmogorov-Smirnov statistic of the two draws, each
  standardised by its own mean and standard deviation, lies under its
  alpha = 1e-3 critical value 1.95 sqrt(2 / n); that of the draws as
  they are lies under the critical value at alpha = 1e-3 for the family
  of tensors (1e-3 / their count each); the standard deviations agree
  within max(5 %, 5 / sqrt(2 n)); every truncated-normal tensor (a flax
  `kernel`, lecun_normal over fan_in = the product of its leaf's shape
  but the last axis) lies within 2 sqrt(1 / fan_in) / 0.87962566 in both
  draws and reaches 0.9 of it; the constant tensors are equal. That
  case takes over a minute on one core and is in the slow set; the
  same checks run at SMALL_CONF's width at seeds 777, 778 and 779.
  `python -m tests.test_torch_init_draw [SEED]` prints the full-width
  statistics as JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from openeat_torch.bin import train
from openeat_torch.quality import init_draw, report
from openeat_torch.models.asr_model import build_asr_model, init_parameters
from openeat_torch.utils.common import make_generator
from openeat_tpu.utils.checkpoint import _flatten
from tests.make_tiny_data import build as build_tiny
from tests.test_torch_flax_init import DRAW_LINE, SMALL_CONF, flax_init
from tests.test_torch_recognize import REPO

torch.set_num_threads(1)
RUN_A = os.path.join(REPO, "openeat_torch", "quality", "results",
                     "h100_lmhard", "run_a", "train.json")
TRUNC = 0.87962566103423978
KS_C = 1.95                 # sqrt(-ln(1e-3 / 2) / 2)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A tiny dataset, and {seed: conf.json of SMALL_CONF's model with
    that seed} at 777 and 778."""
    root = tmp_path_factory.mktemp("init_draw")
    data = build_tiny(str(root / "data"), n_utts=8, seed=5, max_dur=1.4)
    confs = {}
    for seed in (777, 778):
        confs[seed] = str(root / f"conf_{seed}.json")
        with open(confs[seed], "w") as f:
            json.dump({"model_conf": dict(SMALL_CONF),
                       "dataset_conf": {"batch_type": "static",
                                        "batch_size": 4},
                       "optim_conf": {"lr": 0.001}, "warmup_steps": 10,
                       "log_interval": 1, "seed": seed}, f)
    return root, data, confs


def _train(conf: str, data: dict, exp: str, *extra: str):
    return train.main(["--config", conf, "--train_data", data["manifest"],
                       "--cv_data", data["manifest"], "--exp_dir", exp,
                       "--dict", data["dict"], "--device", "cpu",
                       "--num_workers", "1", *extra])


@pytest.mark.parametrize("seed", [777, 778])
def test_draw_equals_bin_train_own(tiny, seed):
    root, data, confs = tiny
    own = _train(confs[seed], data, str(root / f"own{seed}"),
                 "--max_epoch", "0").model.state_dict()
    out = str(root / f"draw{seed}")
    init_draw.main([confs[seed], data["dict"], str(seed), out])
    got = torch.load(os.path.join(out, "epoch_0.pt"), weights_only=True)
    with open(os.path.join(out, "epoch_0.json")) as f:
        assert json.load(f) == {"epoch": 0, "step": 0}
    assert list(got) == list(own)
    for name, value in own.items():
        assert got[name].dtype == value.dtype, name
        assert torch.equal(got[name], value), name


def test_printed_sha256_is_stable(tiny, capsys):
    root, data, confs = tiny
    digests, lines = [], []
    for i in range(2):
        digests.append(init_draw.main([confs[777], data["dict"], "777",
                                       str(root / f"sha{i}")]))
        lines.append(capsys.readouterr().out.strip())
    assert digests[0] == digests[1]
    assert len(digests[0]) == 64
    n = len(torch.load(root / "sha0" / "epoch_0.pt", weights_only=True))
    for i, line in enumerate(lines):
        assert line.startswith(f"{root / f'sha{i}' / 'epoch_0.pt'}: seed "
                               f"777, {n} tensors, ")
        assert line.endswith(f" parameters, sha256 {digests[0]}")
    other = init_draw.main([confs[777], data["dict"], "778",
                            str(root / "sha778")])
    assert other != digests[0]


def test_per_tensor_file_has_every_key_and_is_stable(tiny):
    """--per_tensor writes one sha256 a state-dict key, the same on two
    calls, each that of the tensor it names."""
    root, data, confs = tiny
    files = []
    for i in range(2):
        files.append(str(root / f"per_tensor{i}.json"))
        init_draw.main([confs[777], data["dict"], "777",
                        str(root / f"per{i}"), "--per_tensor", files[-1]])
    with open(files[0]) as f:
        text = f.read()
    with open(files[1]) as f:
        assert f.read() == text
    got = json.loads(text)
    state = torch.load(root / "per0" / "epoch_0.pt", weights_only=True)
    assert list(got) == sorted(state)
    assert len(text.splitlines()) == len(state) + 2
    assert got == init_draw.tensor_sha256(state)
    assert all(len(v) == 64 for v in got.values())
    assert len(set(got.values())) == len(got)


def test_against_groups_the_differing_tensors_by_call(tiny, capsys):
    """--against another per-tensor file prints, for each group of
    in-place calls that drew a tensor, how many differ: none against
    the same draw, the one altered entry by name otherwise; the groups
    are init_parameters' (a truncated normal, the embeddings' normal_,
    the rel-pos biases' uniform_, fill_ and zero_) and the recording
    leaves the draw's bits as they are."""
    root, data, confs = tiny
    ref = str(root / "against.json")
    digest = init_draw.main([confs[777], data["dict"], "777",
                             str(root / "against"), "--per_tensor", ref])
    capsys.readouterr()
    with open(ref) as f:
        theirs = json.load(f)
    name = "ctc.ctc_lo.weight"
    theirs[name] = "0" * 64
    altered = str(root / "altered.json")
    with open(altered, "w") as f:
        json.dump(theirs, f)
    outs = []
    for other in (ref, altered):
        again = init_draw.main([confs[777], data["dict"], "777",
                                str(root / "against2"), "--against", other])
        assert again == digest
        outs.append(capsys.readouterr().out.splitlines()[:-1])
    groups = {line.split(":")[0] for line in outs[0]}
    assert {"fill_", "zero_", "normal_", "uniform_"} <= groups
    assert len(groups) == 5
    assert all(line.endswith(" 0 differ") for line in outs[0])
    trunc = (groups - {"fill_", "zero_", "normal_", "uniform_"}).pop()
    changed = [x for x in outs[1] if not x.endswith(" 0 differ")]
    assert len(changed) == 1 and changed[0].startswith(f"{trunc}: ")
    assert changed[0].endswith(f" 1 differ: {name}")


def test_train_resumes_from_the_draw_at_step_zero(tiny):
    """bin.train --checkpoint epoch_0.pt (no optimizer.pt) starts at
    epoch 0 and step 0 from the writer's weights at another seed than
    the config's, with the schedule's first lr, and writes epoch_1."""
    root, data, confs = tiny
    exp = str(root / "resume")
    init_draw.main([confs[777], data["dict"], "778", exp])
    init = torch.load(os.path.join(exp, "epoch_0.pt"), weights_only=True)
    own = _train(confs[777], data, str(root / "resume_own"),
                 "--max_epoch", "0").model.state_dict()
    assert any(not torch.equal(init[k], own[k]) for k in init)
    state = _train(confs[777], data, exp, "--max_epoch", "1",
                   "--checkpoint", os.path.join(exp, "epoch_0.pt"))
    with open(os.path.join(exp, "train.log")) as f:
        log = f.read()
    assert f"initialized {len(init)} tensors" in log
    assert "restored optimizer state" not in log
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        rows = [json.loads(x) for x in f]
    steps = [r for r in rows if r["kind"] == "train"]
    assert [r["step"] for r in steps] == [1, 2] == [1, state.step]
    assert [r["epoch"] for r in steps] == [0, 0]
    # WarmupLR, linear over its first 10 steps
    np.testing.assert_allclose([r["lr"] for r in steps],
                               [0.001 / 10, 0.002 / 10], rtol=1e-6)
    with open(os.path.join(exp, "epoch_1.json")) as f:
        info = json.load(f)
    assert (info["epoch"], info["step"]) == (1, 2)


def test_imports_no_jax(tiny):
    """The writer runs in a process where no jax, flax, optax or
    openeat_tpu module loads."""
    root, data, confs = tiny
    conf_path = confs[777]
    code = (
        "import sys\n"
        "from openeat_torch.quality import init_draw\n"
        f"init_draw.main([{conf_path!r}, {data['dict']!r}, '777', "
        f"{str(root / 'nojax')!r}])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'openeat_tpu'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(root),
                         env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "sha256" in out.stdout


def test_results_readme_holds_the_report_of_the_draw_runs(capsys,
                                                         monkeypatch):
    """The committed card runs from the port's draws at 778 and 779:
    each resumed from the writer's 620-tensor draw at its seed, the
    README holds report.py's tables over them beside run_a and
    run_flax_init, and each gate line is the one stage 8 printed."""
    root = os.path.dirname(os.path.dirname(RUN_A))
    for seed in (778, 779):
        run = os.path.join(root, f"run_draw{seed}")
        with open(os.path.join(run, "init_draw.txt")) as f:
            assert f.readline().startswith(
                f"WORK/exp/epoch_0.pt: seed {seed}, 620 tensors, "
                "27248290 parameters, sha256 ")
        with open(os.path.join(run, "train_log_head.txt")) as f:
            assert "initialized 620 tensors from WORK/exp/epoch_0.pt" \
                in f.read()
        with open(os.path.join(run, "epoch_0.json")) as f:
            assert json.load(f) == {"epoch": 0, "step": 0}
    monkeypatch.chdir(root)
    report.main(["run_a", "run_flax_init", "run_draw778", "run_draw779"])
    out = capsys.readouterr().out
    with open(os.path.join(root, "README.md"), encoding="utf-8") as f:
        assert out in f.read()
    assert ("QUALITY_GATE FAIL: rescoring 13.99 - greedy 14.09 = -0.10 > "
            "-0.2 (rescoring must help)") in out
    assert out.count("QUALITY_GATE PASS") == 2


def test_results_readme_holds_the_report_of_the_flax_draw_runs(
        capsys, monkeypatch):
    """The committed card runs from flax's draws at 778 and 779: each
    started from the flax writer's 620-tensor draw at its seed at step
    0, the README holds report.py's tables over all six draws with the
    draws table and both permutation chances, and each gate line is the
    one stage 8 printed; run_flax778 holds the card host's per-tensor
    file of the port's draw at 777, one entry a tensor."""
    root = os.path.dirname(os.path.dirname(RUN_A))
    for seed in (778, 779):
        run = os.path.join(root, f"run_flax{seed}")
        with open(os.path.join(run, "init_draw.txt")) as f:
            m = DRAW_LINE.match(f.readline().strip())
        assert m and (int(m[2]), int(m[3]), int(m[4])) == (
            seed, 620, 27248290)
        with open(os.path.join(run, "train_log_head.txt")) as f:
            assert "initialized 620 tensors from WORK/exp/epoch_0.pt" \
                in f.read()
        with open(os.path.join(run, "epoch_0.json")) as f:
            assert json.load(f) == {"epoch": 0, "step": 0}
    with open(os.path.join(root, "run_flax778", "host777",
                           "per_tensor_777_native.json")) as f:
        per_tensor = json.load(f)
    assert len(per_tensor) == 620
    monkeypatch.chdir(root)
    report.main(["run_a", "run_flax_init", "run_draw778", "run_draw779",
                 "run_flax778", "run_flax779"])
    out = capsys.readouterr().out
    with open(os.path.join(root, "README.md"), encoding="utf-8") as f:
        assert out in f.read()
    assert "### Draws" in out and "C(6,3) = 20 splits" in out
    assert "- mean gap in epochs 2-5 (port above flax): 2/20" in out
    assert "- alignment epoch (port later than flax): 14/20" in out
    assert ("QUALITY_GATE FAIL: rescoring 14.49 - greedy 14.56 = -0.07 > "
            "-0.2 (rescoring must help)") in out
    assert out.count("QUALITY_GATE PASS") == 3
    assert out.count("QUALITY_GATE FAIL") == 3


# ------------------------------------- the initializers at full width

def _ks(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sample Kolmogorov-Smirnov statistic."""
    a, b = np.sort(a), np.sort(b)
    x = np.concatenate([a, b])
    return float(np.max(np.abs(np.searchsorted(a, x, side="right") / a.size
                               - np.searchsorted(b, x, side="right")
                               / b.size)))


def _kernel_fan_in(params) -> dict[str, int]:
    """{port tensor name: fan_in} of every flax `kernel` leaf (Dense,
    Conv and depthwise Conv all map `kernel` to `weight`)."""
    out = {}
    for key, value in _flatten(params).items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        if parts[-1] == "kernel":
            out[".".join(parts[:-1]) + ".weight"] = int(
                np.prod(np.shape(value)[:-1]))
    return out


def leaf_stats(flax_state: dict, port_state: dict,
               fan_in: dict[str, int]) -> tuple[list, dict]:
    """The module docstring's checks over every parameter: (the
    failures, a summary of the statistics)."""
    bad, raw_ratio, std_ratio = [], [], []
    assert set(flax_state) <= set(port_state)
    varying = [k for k, v in flax_state.items() if float(v.std()) > 0.0]
    # the raw draws: one test a varying tensor, alpha 1e-3 for the family
    family = (-np.log(1e-3 / len(varying) / 2) / 2) ** 0.5
    for name, fw in flax_state.items():
        a = fw.double().numpy().ravel()
        b = port_state[name].double().numpy().ravel()
        if name not in varying:
            if not np.array_equal(a, b):
                bad.append((name, "constant"))
            continue
        n = a.size
        crit = KS_C * (2.0 / n) ** 0.5
        std = _ks((a - a.mean()) / a.std(), (b - b.mean()) / b.std())
        raw = _ks(a, b)
        raw_ratio.append(raw / crit)
        std_ratio.append(std / crit)
        if std >= crit or raw >= crit * family / KS_C:
            bad.append((name, "ks", n, raw, std, crit))
        ratio = float(b.std() / a.std())
        if abs(ratio - 1.0) > max(0.05, 5 / (2 * n) ** 0.5):
            bad.append((name, "std", n, ratio))
        if name in fan_in:
            bound = 2 * (1.0 / fan_in[name]) ** 0.5 / TRUNC
            for who, x in (("flax", a), ("port", b)):
                top = float(np.abs(x).max())
                if top > bound * (1 + 1e-6) or top < 0.9 * bound:
                    bad.append((name, who, "truncation", top, bound))
    summary = {
        "tensors": len(flax_state), "varying": len(varying),
        "truncated_normal": len(fan_in),
        "standardised_ks_over_crit_max": max(std_ratio),
        "raw_ks_over_crit": {
            "median": float(np.median(raw_ratio)),
            "max": max(raw_ratio),
            "over_1": int(np.sum(np.array(raw_ratio) >= 1.0))},
        "raw_family_crit_over_crit": family / KS_C}
    return bad, summary


def drive_width_stats(seed: int = 777) -> tuple[list, dict]:
    """leaf_stats of flax's draw and the port's at the drive's width."""
    with open(RUN_A) as f:
        cfg = json.load(f)
    assert (cfg["input_size"], cfg["vocab_size"]) == (80, 54)
    mc = cfg["model_conf"]
    assert (mc["d_model"], mc["encoder_num_blocks"],
            mc["linear_units"], mc["decoder_num_blocks"],
            mc["r_decoder_num_blocks"]) == (256, 12, 1024, 3, 3)
    flax_state, _, _, params = flax_init(cfg, seed=seed)
    port_state = init_draw.draw(cfg, cfg["vocab_size"], seed)
    return leaf_stats(flax_state, port_state, _kernel_fan_in(params))


@pytest.mark.slow
def test_initializers_match_flax_at_the_drive_width():
    """Over a minute on one core (flax's jitted init of the full
    model), so in the slow set; the narrow case below runs the same
    checks at seeds 777-779."""
    bad, summary = drive_width_stats(777)
    assert summary["tensors"] == 620
    assert summary["truncated_normal"] > 100
    assert bad == []


@pytest.mark.parametrize("seed", [777, 778, 779])
def test_initializers_match_flax_narrow(seed):
    """The same checks at SMALL_CONF's width, at the drive's seeds."""
    cfg = {"model_conf": dict(SMALL_CONF), "input_size": 80,
           "vocab_size": 30, "use_global_cmvn": False}
    flax_state, _, _, params = flax_init(cfg, seed=seed)
    model = build_asr_model(cfg["model_conf"], 80, 30)
    init_parameters(model, make_generator(seed))
    bad, _ = leaf_stats(flax_state, model.state_dict(),
                        _kernel_fan_in(params))
    assert bad == []


if __name__ == "__main__":
    # python -m tests.test_torch_init_draw [SEED]: the full-width
    # statistics as JSON
    import jax
    jax.config.update("jax_platforms", "cpu")
    failures, stats = drive_width_stats(
        int(sys.argv[1]) if len(sys.argv) > 1 else 777)
    print(json.dumps(dict(stats, failures=[str(x) for x in failures])))
