"""Build and load the port's CUDA kernel libraries.

Each library is one CUDA source under a kernel package's ``csrc/``,
compiled at first use with ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes``.  Libraries land in ``build/kernels/``
at the root of the checkout (listed in ``.gitignore``), under a name keyed
by a hash of the sources, the headers a library force-includes and the
flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is.  A library may add its own flags (``-D…``) and headers
(``-include``): the user variants of the pairwise kernels build
``pairwise_wgmma.cu`` with a generated header there.  The compile writes to a temporary
name and is renamed into place, so a process never loads a half-written
library.

Flags: ``-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC``; no fast-math flag, so ``expf``/``sqrtf`` and float
division stay IEEE (the f32 policy's 1e-5 gate depends on it).
``-Xptxas -v`` makes the compiler report registers, shared memory and
spills per kernel; the report is kept beside the library (``build_log()``).

``build_all`` compiles several libraries at once, one ``nvcc`` each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, List, Optional, Sequence

#: <checkout>/build/kernels (src/repro_torch/kernels -> checkout)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels are compiled from csrc/ at first use")


class Library:
    """One CUDA library: its sources, its C interface (``bind`` sets the
    ctypes signatures) and its build at first use."""

    def __init__(self, name: str, sources: Sequence[Path],
                 bind: Callable[[ctypes.CDLL], ctypes.CDLL],
                 flags: Sequence[str] = (), headers: Sequence[Path] = ()):
        self.name = name
        self.sources = tuple(sources)
        self.flags = tuple(flags)
        self.headers = tuple(headers)
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._build_seconds: Optional[float] = None

    def source_hash(self) -> str:
        """Hash of the sources, the force-included headers and the compile
        flags."""
        h = hashlib.sha256()
        for src in (*self.sources, *self.headers):
            h.update(src.read_bytes())
        h.update(" ".join((*NVCC_FLAGS, *self.flags)).encode())
        return h.hexdigest()[:16]

    def library_path(self) -> Path:
        return BUILD_DIR / f"lib{self.name}_{self.source_hash()}.so"

    def nvcc_command(self, nvcc: str, out: Path) -> List[str]:
        includes = [a for h in self.headers for a in ("-include", str(h))]
        return [nvcc, *NVCC_FLAGS, *self.flags, *includes, "-o", str(out),
                *map(str, self.sources)]

    def build(self) -> Path:
        """Compile the library unless the hashed one exists; returns its
        path."""
        path = self.library_path()
        if path.exists():
            return path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}."
                             f"{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(self.nvcc_command(find_nvcc(), tmp),
                              capture_output=True, text=True, check=False)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.name} "
                               f"({proc.returncode}):\n{log}")
        path.with_suffix(".log").write_text(log)
        os.replace(tmp, path)
        self._build_seconds = time.perf_counter() - t0
        return path

    def build_seconds(self) -> Optional[float]:
        """Seconds this process spent in nvcc (None: the library was
        cached)."""
        return self._build_seconds

    def build_log(self) -> str:
        """The compiler's report of the current build (``-Xptxas -v``)."""
        log = self.library_path().with_suffix(".log")
        return log.read_text() if log.exists() else ""

    def load(self) -> ctypes.CDLL:
        """The bound library, built at first use (thread-safe, once per
        process)."""
        with self._lock:
            if self._lib is None:
                self._lib = self._bind(ctypes.CDLL(str(self.build())))
            return self._lib


def build_all(libraries: Sequence[Library]) -> List[ctypes.CDLL]:
    """Build and load every library, the compiles running side by side."""
    with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        futures = [pool.submit(lib.load) for lib in libraries]
        return [f.result() for f in futures]
