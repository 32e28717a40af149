"""Build a CUDA source of openeat_torch/csrc into a shared library.

nvcc compiles the file by hand (no PyTorch headers, no ninja) into
``openeat_torch/_build/``, named by a hash of the source so an edited
source is rebuilt. The library exposes a plain C interface and is loaded
with ctypes. Nothing here runs at import time: a kernel's wrapper calls
:func:`load_library` on its first launch. While a profiler runs, each
launch sits in a region named after its C entry point
(:func:`launch_region`), so a trace names the entry beside its device
kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def launch_region(entry: str):
    """A torch.profiler region named `entry` (the C entry point a
    wrapper calls) while a profiler runs; no region otherwise, so an
    unprofiled launch pays nothing for it."""
    if getattr(torch.autograd.profiler, "_is_profiler_enabled", True):
        return torch.profiler.record_function(entry)
    return contextlib.nullcontext()


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); it is needed to build the "
                       "CUDA kernels of openeat_torch")


def _library_path(source: str) -> Path:
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}_{digest}.so"


def build_libraries(sources: list[str]) -> list[Path]:
    """Compile each csrc/<source> that has no build of the same text
    yet, one nvcc process per source, all started together. Returns the
    shared libraries' paths; each compiler's output (registers, shared
    memory, spills) is kept beside its library as ``.log``."""
    libs = [_library_path(s) for s in sources]
    jobs = []
    for source, lib in zip(sources, libs):
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / source)]
        jobs.append((source, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for source, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {source}:\n"
                          f"{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)  # atomic: a concurrent process sees all or none
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build_library(source: str) -> Path:
    """Compile csrc/<source> unless a build of the same text exists."""
    return build_libraries([source])[0]


def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<source>, once per process."""
    if source not in _loaded:
        _loaded[source] = ctypes.CDLL(str(build_library(source)))
    return _loaded[source]


def build_log(source: str) -> str:
    """The compiler output kept by :func:`build_library`."""
    return build_library(source).with_suffix(".log").read_text()


def ptxas_entries(log: str) -> list[dict]:
    """Each kernel entry's registers and spills from a ``-v`` build log:
    ``{"entry", "registers", "spill_stores", "spill_loads"}`` (bytes),
    in the order ptxas compiled them."""
    entries: list[dict] = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entries.append({"entry": m.group(1), "registers": None,
                            "spill_stores": None, "spill_loads": None})
            continue
        if not entries:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            entries[-1]["spill_stores"] = int(m.group(1))
            entries[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entries[-1]["registers"] = int(m.group(1))
    return entries
