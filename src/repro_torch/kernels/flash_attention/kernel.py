"""Online-softmax (flash) attention: CUDA wrapper, its plain PyTorch
version, and launch counters (port of
``repro.kernels.flash_attention.kernel``).

Two hand-written CUDA C++ kernels replace the Pallas
``flash_attention_padded`` (body ``_flash_kernel``), and the dtype of the
inputs picks one -- the only route choice:

- **bf16** q, k, v run the tensor-core kernel (``csrc/flash_wgmma.cu``):
  ``wgmma`` bf16 x bf16 -> f32 fed by TMA, P rounded to bf16 for the PV
  product.  TMA needs 16-byte aligned bases and batch/head/row strides; an
  input that breaks that raises (``tma_strides``), it never falls back.
- **f32** q, k, v run the CUDA-core kernel (``csrc/flash.cu``): FP32 FMAs
  throughout, because the f32 gate (1e-5 against the plain version) rules
  out bf16 or TF32 operands.

Both compute the reference's causal and sliding-window masks, decode
right-alignment ``offs = Sk − Sq``, GQA by reading kv head ``h // (Hq /
Hkv)`` (K and V are never repeated in memory), guards for fully masked
tiles, and ``acc / max(l, 1e-30)``.  Lengths need not be tile multiples
and nothing is padded.  Tensors may be strided views (the model passes
(B, S, H, D) activations transposed to (B, H, S, D)) as long as the
feature axis is contiguous; the output takes q's layout.

``flash_attention_cuda.launches`` counts every launch and
``flash_attention_cuda.launches_tc`` the tensor-core kernel's (each bumped
where its kernel is launched and nowhere else); ``launch_counts()`` reads
both.  CPU tensors never reach them: ``ops`` sends them to the plain
version (``flash_attention_plain``).

``flash_attention_op`` is the custom op ``repro_torch::flash_attention``
that ``ops`` calls: its CUDA kernel is ``flash_attention_cuda``, its CPU
kernel the plain version written into the layout the CUDA kernel gives
(``_out_like``), and its fake kernel that layout alone, so a model traces
on ``meta`` tensors (``launch.dryrun``).  Its FLOP formula
(``flash_flops``) counts the (query, key) pairs the mask lets through,
2·D + 2·Dv FLOPs each, for ``torch.utils.flop_counter``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch
import torch.utils.flop_counter

from repro_torch.kernels.flash_attention.ref import \
    attention as flash_attention_plain  # noqa: F401  (the plain version)

#: dtypes the kernel reads q, k, v in (one dtype for all three) and writes
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: widest head the kernels take (D and Dv); wider heads raise
MAX_HEAD_DIM = 256
#: query rows per block of the tensor-core kernel (its grid's y extent is
#: ceil(Sq / TC_BLOCK_Q) <= 65,535)
TC_BLOCK_Q = 128


def softmax_scale(D: int) -> float:
    """1/√D rounded to f32, as the Pallas body scales its f32 logits."""
    return float(np.float32(1.0 / math.sqrt(D)))


def _check(q, k, v, window) -> None:
    for name, X in (("q", q), ("k", k), ("v", v)):
        if not isinstance(X, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if X.ndim != 4:
            raise ValueError(f"{name} must be 4-d (B, H, S, D), got "
                             f"{tuple(X.shape)}")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one dtype of {KERNEL_DTYPES}"
                        f" (got {q.dtype}, {k.dtype}, {v.dtype})")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, Dk = k.shape
    if k.shape[0] != B or v.shape[0] != B or v.shape[1] != Hkv or \
            v.shape[2] != Sk or Dk != D:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    Dv = v.shape[3]
    if Hkv == 0 or Hq % Hkv != 0:
        raise ValueError(f"Hq = {Hq} must be a multiple of Hkv = {Hkv}")
    if not (1 <= D <= MAX_HEAD_DIM and 1 <= Dv <= MAX_HEAD_DIM):
        raise ValueError(f"the kernel takes head dims D, Dv in [1, "
                         f"{MAX_HEAD_DIM}] (got D = {D}, Dv = {Dv})")
    if window is not None and not 1 <= window < 2 ** 31:
        raise ValueError(f"window must be in [1, 2^31) (got {window})")
    if max(Sq, Sk) >= 2 ** 31 or max(B, Hq) > 65535:
        raise ValueError(f"the kernel takes Sq, Sk < 2^31 and B, Hq ≤ "
                         f"65,535 (got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)})")
    for name, X in (("q", q), ("k", k), ("v", v)):
        if X.device.type != "cuda":
            raise ValueError(f"the CUDA kernel takes CUDA tensors (got "
                             f"{name} on {X.device})")
        if X.device != q.device:
            raise ValueError(f"{name} on {X.device} but q on {q.device}")
        if X.shape[3] > 1 and X.stride(3) != 1:
            raise ValueError(f"the CUDA kernel needs a contiguous feature "
                             f"axis ({name} has strides {X.stride()})")


def tma_strides(X: torch.Tensor, name: str) -> tuple:
    """The element strides of X's batch, head and row axes for a TMA tensor
    map, or ValueError naming what TMA cannot take: a bf16 base address
    that is not 16-byte aligned, or a stride of an axis longer than 1 that
    is not a positive multiple of 8 elements (16 bytes).  An axis of length
    1 is never stepped, so its stride is replaced by a packed one."""
    if X.data_ptr() % 16:
        raise ValueError(f"the tensor-core kernel loads {name} by TMA, which "
                         f"needs a 16-byte aligned base (address "
                         f"{X.data_ptr():#x})")
    out = []
    packed = -(-X.shape[3] // 8) * 8
    for ax in (2, 1, 0):
        st = X.stride(ax)
        if X.shape[ax] == 1:
            st = packed
        elif st <= 0 or st % 8:
            raise ValueError(f"the tensor-core kernel loads {name} by TMA, "
                             f"which needs batch, head and row strides that "
                             f"are positive multiples of 16 bytes ({name} "
                             f"has strides {X.stride()})")
        out.append(st)
        packed *= X.shape[ax]
    return tuple(reversed(out))


def _out_like(q: torch.Tensor, Dv: int) -> torch.Tensor:
    """The output in q's memory layout when the head dims agree (so a
    (B, S, H, D) activation viewed as (B, H, S, D) gets a (B, S, H, Dv)
    output back), else contiguous."""
    if Dv == q.shape[3] and q.stride(3) == 1:
        return torch.empty_like(q, memory_format=torch.preserve_format)
    B, Hq, Sq, _ = q.shape
    return torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=q.device)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel of q's dtype (bf16: tensor cores, f32: CUDA cores);
    raises on anything it does not take."""
    _check(q, k, v, window)
    B, Hq, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    tc = q.dtype == torch.bfloat16
    if tc:
        if -(-Sq // TC_BLOCK_Q) > 65535:
            raise ValueError(f"the tensor-core kernel takes Sq ≤ "
                             f"{65535 * TC_BLOCK_Q:,} (got {Sq})")
        in_strides = [st for X, name in ((q, "q"), (k, "k"), (v, "v"))
                      for st in tma_strides(X, name)]
    out = _out_like(q, Dv)
    if B == 0 or Hq == 0 or Sq == 0:
        return out
    from repro_torch.kernels.flash_attention import build
    lib = build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if tc:
        strides = (ctypes.c_longlong * 12)(
            *in_strides, *(out.stride(i) for i in range(3)))
        code = lib.flash_attention_tc(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            strides, B, Hq, Hkv, Sq, Sk, D, Dv, int(bool(causal)),
            -1 if window is None else int(window), softmax_scale(D),
            q.device.index or 0, ctypes.c_void_p(stream))
        if code != 0:
            msg = lib.flash_tc_error_string(code).decode()
            raise RuntimeError(f"flash_attention (tensor cores) launch "
                               f"failed: error {code} ({msg})")
        flash_attention_cuda.launches += 1
        flash_attention_cuda.launches_tc += 1
        return out
    strides = (ctypes.c_longlong * 12)(
        *(X.stride(i) for X in (q, k, v, out) for i in range(3)))
    code = lib.flash_attention(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        strides, B, Hq, Hkv, Sq, Sk, D, Dv, 0, int(bool(causal)),
        -1 if window is None else int(window), softmax_scale(D),
        q.device.index or 0, ctypes.c_void_p(stream))
    if code != 0:
        msg = lib.flash_error_string(code).decode()
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{code} ({msg})")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_tc = 0


def launch_counts() -> dict:
    """Launches since the last reset: of both routes (``flash_attention``)
    and of the tensor-core kernel alone (``flash_attention_tc``)."""
    return {"flash_attention": flash_attention_cuda.launches,
            "flash_attention_tc": flash_attention_cuda.launches_tc}


def reset_launch_counts() -> None:
    flash_attention_cuda.launches = 0
    flash_attention_cuda.launches_tc = 0


# ---------------------------------------------------------------------------
# the custom op: what a dispatcher mode (a FLOP counter, an op recorder, a
# trace on ``meta``) sees as one call
# ---------------------------------------------------------------------------

def visible_pairs(Sq: int, Sk: int, causal: bool,
                  window: Optional[int]) -> int:
    """The (query, key) pairs the mask lets through for one (batch, query
    head): query i sits at key position i + Sk − Sq; causal keeps keys at
    or before it, ``window`` = w keeps keys less than w behind it."""
    p = np.arange(Sq, dtype=np.int64) + (Sk - Sq)
    hi = np.minimum(Sk, p + 1) if causal else np.full(Sq, Sk, np.int64)
    lo = np.zeros(Sq, np.int64) if window is None \
        else np.maximum(0, p - int(window) + 1)
    return int(np.maximum(hi - lo, 0).sum())


def flash_flops(q_shape, k_shape, v_shape, causal: bool,
                window: Optional[int]) -> int:
    """B6's work: 2·D FLOPs for a pair's score and 2·Dv for its share of
    the read, over the visible pairs of every (batch, query head)."""
    B, Hq, Sq, D = q_shape
    Sk, Dv = k_shape[2], v_shape[3]
    return B * Hq * visible_pairs(Sq, Sk, causal, window) * (2 * D + 2 * Dv)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: Optional[int]) -> torch.Tensor:
    # dispatched by device: the CPU kernel below, the CUDA one after it
    raise NotImplementedError(f"flash_attention on {q.device}")


@flash_attention_op.register_kernel("cpu")
def _flash_cpu(q, k, v, causal, window):
    plain = flash_attention_plain(q, k, v, causal=causal, window=window)
    return _out_like(q, v.shape[3]).copy_(plain)


@flash_attention_op.register_kernel("cuda")
def _flash_cuda(q, k, v, causal, window):
    return flash_attention_cuda(q, k, v, causal=causal, window=window)


@flash_attention_op.register_fake
def _flash_fake(q, k, v, causal, window):
    return _out_like(q, v.shape[3])


@torch.utils.flop_counter.register_flop_formula(
    torch.ops.repro_torch.flash_attention)
def _flash_flop_formula(q_shape, k_shape, v_shape, causal, window, *args,
                        out_shape=None, **kwargs) -> int:
    return flash_flops(q_shape, k_shape, v_shape, causal, window)
