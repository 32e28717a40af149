"""ctypes binding of the native audio reader (native/openeat_io.cc).
Port of openeat_tpu/runtime/native_io.py.

The C++ library decodes a whole batch of WAV or FLAC files (or
`start,end` segments of them) on a thread pool, outside the GIL. At
first use it is built from the repo's native/openeat_io.cc with g++ and
native/Makefile's flags (`-march=native` among them) into
openeat_torch/_build/, under a name that hashes the source, the flags
and the instruction sets `-march=native` enables on this CPU; the build
goes to a temporary name and is moved into place with os.replace, so
that processes building at once never load a half-written file. Nothing is written into native/.
Without g++ (or when the build fails) `available()` is False and the
collate reads with the Python decoders, as the JAX package does without
its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR.parent / "native" / "openeat_io.cc"
BUILD_DIR = PACKAGE_DIR / "_build"
# native/Makefile's CXXFLAGS, then its link line
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared"]
LINK_FLAGS = ["-lpthread"]

_LIB: ctypes.CDLL | None = None
_TRIED = False
build_error: str | None = None


def native_target(cxx: str) -> str:
    """What `-march=native` means to `cxx` on this CPU: the macros it
    predefines there, which name every instruction set it enables."""
    proc = subprocess.run([cxx, "-march=native", "-dM", "-E", "-x", "c++",
                           "-"], input="", capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} -march=native failed ({proc.returncode})"
                           f":\n{proc.stderr}")
    return "\n".join(sorted(proc.stdout.splitlines()))


def library_path(cxx: str) -> Path:
    """The library's file: a name that hashes the source, the flags and
    the CPU's instruction sets, so that a build made on another CPU (the
    checkout copied to another host) is never loaded here."""
    digest = hashlib.sha256("\n".join(
        [SOURCE.read_text(), *CXX_FLAGS, *LINK_FLAGS, native_target(cxx)]
    ).encode()).hexdigest()[:16]
    return BUILD_DIR / f"openeat_io_{digest}.so"


def build_library() -> Path:
    """Compile native/openeat_io.cc unless a build of the same source,
    flags and instruction sets exists; returns the library's path."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH (nor $CXX)")
    lib = library_path(cxx)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                           *LINK_FLAGS], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed ({proc.returncode}) on {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED, build_error
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(str(build_library()))
    except (OSError, RuntimeError) as e:
        build_error = str(e)
        return None
    lib.oet_read_wav_batch.restype = ctypes.c_int
    lib.oet_read_wav_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
    lib.oet_wav_info.restype = ctypes.c_int
    lib.oet_wav_info.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int64),
                                 ctypes.POINTER(ctypes.c_int32)]
    _LIB = lib
    return lib


def available() -> bool:
    """Whether the library is built and loaded (building it if need be)."""
    return _load() is not None


def read_wav_batch(paths: Sequence[str],
                   starts: Sequence[Optional[float]],
                   ends: Sequence[Optional[float]],
                   max_samples: int, n_threads: int = 8
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode on the thread pool -> (wav [n, max_samples] float32 in
    [-1, 1], lens [n] int64, rates [n] int32). A row is defined up to its
    length only; a file that fails has length 0; a longer file is cut at
    max_samples."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native IO library unavailable: {build_error}")
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode("utf-8") for p in paths])
    c_starts = (ctypes.c_double * n)(
        *[-1.0 if s is None else float(s) for s in starts])
    c_ends = (ctypes.c_double * n)(
        *[-1.0 if e is None else float(e) for e in ends])
    out = np.empty((n, max_samples), np.float32)
    out_lens = np.zeros((n,), np.int64)
    out_rates = np.zeros((n,), np.int32)
    lib.oet_read_wav_batch(
        c_paths, c_starts, c_ends, n, n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_samples,
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out, out_lens, out_rates


def wav_info(path: str) -> tuple[int, int]:
    """(samples, rate) of one file."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native IO library unavailable: {build_error}")
    n = ctypes.c_int64()
    r = ctypes.c_int32()
    if lib.oet_wav_info(path.encode("utf-8"), ctypes.byref(n),
                        ctypes.byref(r)) != 0:
        raise ValueError(f"cannot decode {path}")
    return int(n.value), int(r.value)
