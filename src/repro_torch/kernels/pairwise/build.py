"""Build and bind the pairwise CUDA kernels (``csrc/pairwise.cu``).

The source is compiled at first use with ``nvcc`` into a shared library with
a plain C interface and loaded with ``ctypes``.  The library lands in
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
under a name keyed by a hash of the sources and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  The compile
writes to a temporary name and is renamed into place, so a process never
loads a half-written library.

Flags: ``-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC``; no fast-math flag, so ``expf``/``sqrtf`` and float
division stay IEEE (the f32 policy's 1e-5 gate depends on it).
``-Xptxas -v`` makes the compiler report registers, shared memory and
spills per kernel; the report is kept beside the library (``build_log()``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "pairwise.cu",)
#: <checkout>/build/kernels (src/repro_torch/kernels/pairwise -> checkout)
BUILD_DIR = _HERE.parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_BUILD_SECONDS: Optional[float] = None


def source_hash() -> str:
    """Hash of the kernel sources and the compile flags."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libpairwise_{source_hash()}.so"


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the pairwise "
        "CUDA kernels are compiled from csrc/ at first use")


def nvcc_command(nvcc: str, out: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *map(str, SOURCES)]


def build() -> Path:
    """Compile the library unless the hashed one exists; returns its path."""
    global _BUILD_SECONDS
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(nvcc_command(find_nvcc(), tmp), capture_output=True,
                          text=True, check=False)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    path.with_suffix(".log").write_text(log)
    os.replace(tmp, path)
    _BUILD_SECONDS = time.perf_counter() - t0
    return path


def build_seconds() -> Optional[float]:
    """Seconds this process spent in nvcc (None: the library was cached)."""
    return _BUILD_SECONDS


def build_log() -> str:
    """The compiler's report of the current build (``-Xptxas -v``)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ll, i, f, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_float, \
        ctypes.c_void_p
    lib.pairwise_block_f32.argtypes = [p, p, p, ll, ll, i, i, i, f, f, i, i,
                                       i, p]
    lib.pairwise_block_f32.restype = i
    lib.pairwise_matmat_multi_f32.argtypes = [p, p, p, p, ll, ll, i, ll, i,
                                              i, f, f, i, i, i, p]
    lib.pairwise_matmat_multi_f32.restype = i
    lib.pairwise_error_string.argtypes = [i]
    lib.pairwise_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """The bound library, built at first use (thread-safe, once per
    process)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(build())))
        return _LIB
