"""The fused landmark-attention read: CUDA wrapper, its plain PyTorch
version, and a launch counter (port of
``repro.kernels.landmark_attention.kernel``).

One kernel, hand-written in CUDA C++ (``csrc/landmark.cu``), replaces the
Pallas ``landmark_read_padded``:

    out = (exp(Q k_landᵀ/√d − off) @ UV) / sgnfloor(exp(…) @ U1, 1e-6)

It takes any m (rows are masked in the kernel, nothing is padded to 128)
and keeps the (m, c) score panel on chip.  Dispatch is by the device of the
tensors: CPU tensors run the plain version (``landmark_read_plain``, the
oracle of ``ref``); CUDA tensors launch the kernel through
``landmark_read_cuda`` or raise — there is no fallback.
``landmark_read_cuda.launches`` counts the launches (bumped where the kernel
is launched and nowhere else).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.landmark_attention.ref import inv_sqrt_d
from repro_torch.kernels.landmark_attention.ref import \
    landmark_read as landmark_read_plain  # noqa: F401  (the plain version)

#: dtypes the kernel reads Q, k_land and UV in, and writes out in
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check(Q, k_land, UV, U1, offset, out_dtype) -> None:
    for name, X in (("Q", Q), ("k_land", k_land), ("UV", UV), ("U1", U1),
                    ("offset", offset)):
        if not isinstance(X, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if X.device.type != "cuda":
            raise ValueError(f"the CUDA kernel takes CUDA tensors (got "
                             f"{name} on {X.device})")
        if X.device != Q.device:
            raise ValueError(f"{name} on {X.device} but Q on {Q.device}")
        if not X.is_contiguous():
            raise ValueError(f"the CUDA kernel takes contiguous row-major "
                             f"tensors ({name} is not)")
    if Q.dtype not in KERNEL_DTYPES or k_land.dtype != Q.dtype or \
            UV.dtype != Q.dtype:
        raise TypeError(f"Q, k_land and UV must share one dtype of "
                        f"{KERNEL_DTYPES} (got {Q.dtype}, {k_land.dtype}, "
                        f"{UV.dtype})")
    if U1.dtype != torch.float32 or offset.dtype != torch.float32:
        raise TypeError(f"U1 and offset must be float32 (got {U1.dtype}, "
                        f"{offset.dtype})")
    if out_dtype not in KERNEL_DTYPES:
        raise TypeError(f"the output dtype must be one of {KERNEL_DTYPES} "
                        f"(got {out_dtype})")
    if Q.dtype == torch.bfloat16 and out_dtype != torch.bfloat16:
        raise TypeError(f"bf16 inputs need a bf16 output (got "
                        f"{out_dtype})")
    if Q.ndim != 2 or k_land.ndim != 2 or UV.ndim != 2 or U1.ndim != 1:
        raise ValueError("Q (m, d), k_land (c, d), UV (c, dv) and U1 (c,) "
                         "expected")
    c = k_land.shape[0]
    if k_land.shape[1] != Q.shape[1] or UV.shape[0] != c or \
            U1.shape[0] != c:
        raise ValueError(f"shapes do not match: Q {tuple(Q.shape)}, k_land "
                         f"{tuple(k_land.shape)}, UV {tuple(UV.shape)}, U1 "
                         f"{tuple(U1.shape)}")
    if offset.numel() != 1:
        raise ValueError(f"offset must hold one value (got "
                         f"{tuple(offset.shape)})")
    if Q.shape[1] == 0 or c == 0:
        raise ValueError("the CUDA kernel needs d ≥ 1 and c ≥ 1")


def landmark_read_cuda(Q: torch.Tensor, k_land: torch.Tensor,
                       UV: torch.Tensor, U1: torch.Tensor,
                       offset: torch.Tensor, eps: float = 1e-6,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """Launch the kernel; raises on anything it does not take.  ``offset``
    is a one-element f32 tensor on the card, read there (no sync);
    ``out_dtype`` defaults to Q's."""
    out_dtype = Q.dtype if out_dtype is None else out_dtype
    _check(Q, k_land, UV, U1, offset, out_dtype)
    m, d = Q.shape
    c, dv = UV.shape
    out = torch.empty((m, dv), dtype=out_dtype, device=Q.device)
    if m == 0 or dv == 0:
        return out
    from repro_torch.kernels.landmark_attention import build
    lib = build.load_library()
    stream = torch.cuda.current_stream(Q.device).cuda_stream
    code = lib.landmark_read(
        ctypes.c_void_p(Q.data_ptr()), ctypes.c_void_p(k_land.data_ptr()),
        ctypes.c_void_p(UV.data_ptr()), ctypes.c_void_p(U1.data_ptr()),
        ctypes.c_void_p(offset.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        m, c, d, dv, int(Q.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), inv_sqrt_d(d), eps,
        Q.device.index or 0, ctypes.c_void_p(stream))
    if code != 0:
        msg = lib.landmark_error_string(code).decode()
        raise RuntimeError(f"landmark_read launch failed: CUDA error {code} "
                           f"({msg})")
    landmark_read_cuda.launches += 1
    return out


landmark_read_cuda.launches = 0


def launch_counts() -> dict:
    """Launches of the CUDA kernel since the last reset."""
    return {"landmark_read": landmark_read_cuda.launches}


def reset_launch_counts() -> None:
    landmark_read_cuda.launches = 0
