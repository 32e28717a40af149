"""Build a CUDA source of openeat_torch/csrc into a shared library.

nvcc compiles the file by hand (no PyTorch headers, no ninja) into
``openeat_torch/_build/``, named by a hash of the source so an edited
source is rebuilt. The library exposes a plain C interface and is loaded
with ctypes. Nothing here runs at import time: a kernel's wrapper calls
:func:`load_library` on its first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); it is needed to build the "
                       "CUDA kernels of openeat_torch")


def build_library(source: str) -> Path:
    """Compile csrc/<source> unless a build of the same text exists.
    Returns the path of the shared library; the compiler's output
    (registers, shared memory, spills) is kept beside it as ``.log``."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"{src.stem}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent process sees all or none
    return lib


def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<source>, once per process."""
    if source not in _loaded:
        _loaded[source] = ctypes.CDLL(str(build_library(source)))
    return _loaded[source]


def build_log(source: str) -> str:
    """The compiler output kept by :func:`build_library`."""
    return build_library(source).with_suffix(".log").read_text()
