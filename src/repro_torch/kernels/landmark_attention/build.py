"""Build and bind the landmark-read CUDA kernel (``csrc/landmark.cu``).

The library is built at first use by the shared helper
(``repro_torch.kernels.build``) into ``build/kernels/liblandmark_<hash>.so``;
``LIBRARY.build_log()`` keeps the compiler's ``-Xptxas -v`` report.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import build as _build

SOURCES = (Path(__file__).resolve().parent / "csrc" / "landmark.cu",)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ll, i, f, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_float, \
        ctypes.c_void_p
    lib.landmark_read.argtypes = [p, p, p, p, p, p, ll, i, i, i, i, i, f, f,
                                  i, p]
    lib.landmark_read.restype = i
    lib.landmark_error_string.argtypes = [i]
    lib.landmark_error_string.restype = ctypes.c_char_p
    return lib


LIBRARY = _build.Library("landmark", SOURCES, _bind)

load_library = LIBRARY.load
