"""Build and bind the pairwise CUDA kernels (``csrc/pairwise_wgmma.cu``).

The library is built at first use by the shared helper
(``repro_torch.kernels.build``) into ``build/kernels/libpairwise_<hash>.so``;
``LIBRARY.build_log()`` keeps the compiler's ``-Xptxas -v`` report.

``user_library(program, stat)`` is the same source built for a spec with
only a Python ``entry_fn``: its lowered program (``lower.py``) is written to
``build/kernels/user_entry_<key>.h`` and force-included, and
``-DPAIRWISE_USER_STAT`` instantiates that statistic's kernels only
(``libpairwise_user_<key>_<stat>_<hash>.so``).  Its loader refuses a build
whose ptxas report shows spill stores or loads in any kernel: a spilling
build of these kernels computed wrong entries on the card, so such an
``entry_fn`` runs on CPU tensors only.
"""
from __future__ import annotations

import ctypes
import os
import re
import threading
from pathlib import Path
from typing import Dict, Tuple

from repro_torch.kernels import build as _build
from repro_torch.kernels.pairwise.specs import STAT_IDS

SOURCES = (Path(__file__).resolve().parent / "csrc" / "pairwise_wgmma.cu",)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ll, i, f, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_float, \
        ctypes.c_void_p
    lib.pairwise_workspace_bytes.argtypes = [ll, ll, i, ll, i, i, i]
    lib.pairwise_workspace_bytes.restype = ll
    lib.pairwise_passes.argtypes = [i, i, i]
    lib.pairwise_passes.restype = i
    lib.pairwise_statistic_builds.argtypes = [ll]
    lib.pairwise_statistic_builds.restype = ll
    lib.pairwise_block_f32.argtypes = [p, p, p, ll, ll, i, i, i, f, f, i, i,
                                       p, ll, i, p]
    lib.pairwise_block_f32.restype = i
    lib.pairwise_matmat_multi_f32.argtypes = [p, p, p, p, ll, ll, i, ll, i,
                                              i, i, f, f, i, i, p, ll, i, p]
    lib.pairwise_matmat_multi_f32.restype = i
    lib.pairwise_matmat_multi_slab_f32.argtypes = [p, p, p, ll, ll, ll, i, ll,
                                                   i, i, f, f, i, i, p, ll, i,
                                                   p]
    lib.pairwise_matmat_multi_slab_f32.restype = i
    lib.pairwise_error_string.argtypes = [i]
    lib.pairwise_error_string.restype = ctypes.c_char_p
    return lib


LIBRARY = _build.Library("pairwise", SOURCES, _bind)

load_library = LIBRARY.load

_USER: Dict[Tuple[str, str], _build.Library] = {}
_USER_LOCK = threading.Lock()


def _write_header(program) -> Path:
    """``program.source()`` under ``build/kernels/`` (written once; the name
    carries its hash, so the file never changes once there)."""
    path = _build.BUILD_DIR / f"user_entry_{program.key}.h"
    if not path.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}."
                             f"{threading.get_ident()}.tmp")
        tmp.write_text(program.source())
        os.replace(tmp, path)
    return path


def spills(report: str) -> Dict[str, int]:
    """Spill bytes (stores + loads) of each kernel of an ``-Xptxas -v``
    report that spills, by mangled name."""
    out, entry = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and entry and int(m.group(1)) + int(m.group(2)) > 0:
            out[entry] = int(m.group(1)) + int(m.group(2))
    return out


def user_library(program, stat: str) -> _build.Library:
    """The pairwise kernels with ``program`` as their ``EPI_USER`` epilogue,
    for the statistic ``stat``: one ``Library`` per (program key,
    statistic), bound like ``LIBRARY`` and built at its first ``load``,
    which raises if a kernel of the build spills."""
    key = (program.key, stat)
    with _USER_LOCK:
        lib = _USER.get(key)
        if lib is None:
            def bind(cdll: ctypes.CDLL) -> ctypes.CDLL:
                spilled = spills(lib.build_log())
                if spilled:
                    raise RuntimeError(
                        f"the pairwise kernels built with the entry "
                        f"{program.key} ({stat}) spill registers "
                        f"({spilled}; {lib.library_path().name}): a spilling "
                        f"build of these kernels computed wrong entries, so "
                        f"this entry_fn runs on CPU tensors only")
                return _bind(cdll)

            lib = _build.Library(
                f"pairwise_user_{program.key}_{stat}", SOURCES, bind,
                flags=(f"-DPAIRWISE_USER_STAT={STAT_IDS[stat]}",),
                headers=(_write_header(program),))
            _USER[key] = lib
        return lib
