"""The check that no JAX module is loaded compares whole top-level
names; the harness and the program it drives load none."""

import os
import subprocess
import sys

from perfbench import spec
from perfbench.run import forbidden_modules


def test_whole_top_level_names():
    mods = ["openeat_torch", "openeat_torch.ops", "openeat_tpu_extra",
            "openeat_tpu.models", "jaxlib", "jax.numpy", "jaxify", "flax",
            "flaxen", "numpy"]
    assert forbidden_modules(mods) == ["flax", "jax.numpy", "jaxlib",
                                       "openeat_tpu.models"]


def test_harness_and_program_load_no_jax():
    code = ("import sys\n"
            "import perfbench.run, perfbench.calibrate, perfbench.kinds.train\n"
            "from perfbench.kinds.train import TrainRun\n"
            "import openeat_torch.dataset.dataset, openeat_torch.pipeline\n"
            "import openeat_torch.models.asr_model\n"
            "import openeat_torch.parallel.train_step\n"
            "import openeat_torch.utils.executor\n"
            "from perfbench.run import forbidden_modules\n"
            "print(forbidden_modules())\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_sources_import_no_jax():
    for path in spec.PACKAGE_DIR.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "openeat_tpu",
                                   "benchmarks"), (path, line)
