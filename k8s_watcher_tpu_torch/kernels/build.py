"""Build and load the port's CUDA kernels, and count their launches.

The sources under ``csrc/`` are compiled with ``nvcc`` on first use into
``_build/`` beside the package (listed in ``.gitignore``) as a shared library
with a plain C interface, and loaded with ``ctypes``. The library's file name
carries a hash of the source and flags, so an edited source is rebuilt and a
built one is reused by every later process. Nothing is compiled or loaded at
import: the CPU tests import this module on machines with no ``nvcc``.

Every wrapper in ``kernels/`` calls :func:`count` exactly where it launches
its kernel, so a run can show which kernels its main path went through. A
process started with ``K8S_WATCHER_TPU_LAUNCH_COUNTS=<path>`` writes its
counts as JSON to ``<path>.<RANK>`` when it exits, for a parent that drives a
path through a command (``chip_smoke.py`` runs the DaemonSet's command so).
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCES = (PACKAGE_DIR / "csrc" / "hbm.cu",)
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: ``nvcc``'s output of the build this process ran (``-Xptxas -v``: registers,
#: shared memory and spills per kernel); empty when the library was reused
build_log: str = ""

_launches: Dict[str, int] = {"read_sweep": 0, "fill": 0, "blocksums": 0}


def count(name: str) -> None:
    """Record one launch of kernel ``name`` (called by its wrapper only)."""
    _launches[name] += 1


def launch_counts() -> Dict[str, int]:
    """A copy of the launch counters, by kernel name."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


LAUNCH_COUNTS_ENV = "K8S_WATCHER_TPU_LAUNCH_COUNTS"


def _write_launch_counts(path: str) -> None:
    with open(path, "w") as fh:
        json.dump(launch_counts(), fh)


if os.environ.get(LAUNCH_COUNTS_ENV):
    atexit.register(_write_launch_counts, f"{os.environ[LAUNCH_COUNTS_ENV]}.{os.environ.get('RANK', '0')}")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {candidate} and on PATH): the CUDA kernels "
            "cannot be built on this machine"
        )
    return found


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libk8w_kernels-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them already exists."""
    global build_log
    target = library_path()
    if target.is_file():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never loads
    # a half-written library
    partial = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(partial), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        partial.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    build_log = proc.stdout + proc.stderr
    os.replace(partial, target)
    return target


def load() -> ctypes.CDLL:
    """The kernel library, built on first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.k8w_hbm_read_sweep.argtypes = [ptr, i64, i32, ptr, i32, ptr, ptr, f32p]
            lib.k8w_hbm_fill.argtypes = [ptr, ptr, i64, i32, i32, ptr, f32p]
            lib.k8w_hbm_blocksums.argtypes = [ptr, i32, ptr, ptr]
            lib.k8w_time_graph.argtypes = [ptr, ptr, ptr, f32p]
            for fn in (lib.k8w_hbm_read_sweep, lib.k8w_hbm_fill, lib.k8w_hbm_blocksums, lib.k8w_time_graph):
                fn.restype = i32
            lib.k8w_error_string.argtypes = [i32]
            lib.k8w_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        message = lib.k8w_error_string(code).decode(errors="replace")
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: error {code} ({message})")
