"""Build and bind the pairwise CUDA kernels (``csrc/pairwise_wgmma.cu``).

The library is built at first use by the shared helper
(``repro_torch.kernels.build``) into ``build/kernels/libpairwise_<hash>.so``;
``LIBRARY.build_log()`` keeps the compiler's ``-Xptxas -v`` report.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import build as _build

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
