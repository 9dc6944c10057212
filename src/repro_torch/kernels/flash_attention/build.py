"""Build and bind the flash-attention CUDA kernels: ``csrc/flash.cu`` (the
CUDA-core kernel, f32 inputs) and ``csrc/flash_wgmma.cu`` (the tensor-core
kernel, bf16 inputs), one library.

The library is built at first use by the shared helper
(``repro_torch.kernels.build``) into ``build/kernels/libflash_<hash>.so``;
``LIBRARY.build_log()`` keeps the compiler's ``-Xptxas -v`` report.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import build as _build

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "flash.cu", _CSRC / "flash_wgmma.cu")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    lib.flash_attention.argtypes = [p, p, p, p,
                                    ctypes.POINTER(ctypes.c_longlong),
                                    i, i, i, i, i, i, i, i, i, i, f, i, p]
    lib.flash_attention.restype = i
    lib.flash_error_string.argtypes = [i]
    lib.flash_error_string.restype = ctypes.c_char_p
    lib.flash_attention_tc.argtypes = [p, p, p, p,
                                       ctypes.POINTER(ctypes.c_longlong),
                                       i, i, i, i, i, i, i, i, i, f, i, p]
    lib.flash_attention_tc.restype = i
    lib.flash_tc_error_string.argtypes = [i]
    lib.flash_tc_error_string.restype = ctypes.c_char_p
    return lib


LIBRARY = _build.Library("flash", SOURCES, _bind)

load_library = LIBRARY.load
