"""Build and bind the landmark-read CUDA kernels: ``csrc/landmark_wgmma.cu``
(the tensor-core route) and ``csrc/landmark_split.cu`` (the route split
across the landmarks), one library.

The library is built at first use by the shared helper
(``repro_torch.kernels.build``) into ``build/kernels/liblandmark_<hash>.so``;
``LIBRARY.build_log()`` keeps the compiler's ``-Xptxas -v`` report.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import build as _build

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "landmark_wgmma.cu", _CSRC / "landmark_split.cu")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ll, i, f, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_float, \
        ctypes.c_void_p
    lib.landmark_tc_workspace_bytes.argtypes = [i, i, i, i]
    lib.landmark_tc_workspace_bytes.restype = ll
    lib.landmark_split_workspace_bytes.argtypes = [ll, i, i]
    lib.landmark_split_workspace_bytes.restype = ll
    lib.landmark_passes.argtypes = [i, i]
    lib.landmark_passes.restype = i
    lib.landmark_read_tc.argtypes = [p, p, p, p, p, p, p, ll, ll, i, i, i, i,
                                     i, f, f, i, p]
    lib.landmark_read_tc.restype = i
    lib.landmark_read_split.argtypes = [p, p, p, p, p, p, p, ll, ll, i, i, i,
                                        i, i, i, f, f, i, p]
    lib.landmark_read_split.restype = i
    lib.landmark_error_string.argtypes = [i]
    lib.landmark_error_string.restype = ctypes.c_char_p
    return lib


LIBRARY = _build.Library("landmark", SOURCES, _bind)

load_library = LIBRARY.load
