"""The fused landmark-attention read: CUDA wrapper, its plain PyTorch
version, and launch counters (port of
``repro.kernels.landmark_attention.kernel``).

Two hand-written CUDA C++ routes replace the Pallas ``landmark_read_padded``
(body ``_landmark_kernel``), both computing

    out = (exp(Q k_landᵀ/√d − off) @ UV) / sgnfloor(exp(…) @ U1, 1e-6)

with the (m, c) score panel kept on chip:

- **tensor cores** (``csrc/landmark_wgmma.cu``, one counted call = two prep
  kernels and the read): ``wgmma`` fed by TMA, 128 query rows × 128 UV
  columns a block walking every 64-landmark tile.  f32 inputs in split TF32
  (3 + 3 passes), bf16 inputs in bf16 with P rounded to bf16 for P·UV;
  den = P·U1 on the CUDA cores from the same rounded P;
- **split across the landmarks** (``csrc/landmark_split.cu``, two
  launches): 16 rows × 64 UV columns × a run of 64-landmark chunks a block,
  FP32 FMAs on the CUDA cores, partial num/den in a workspace, then a
  reduction over the runs in a fixed order (no atomics).

``landmark_read_cuda`` picks the route (``tensor_core_route``) from block
counts against the SMs (132 on the H100 SXM, read from the device).  The
tensor-core grid has ceil(m/128)·ceil(dv/128) blocks, one an SM, each
walking all c landmarks: at a decode step it is 2 blocks and the card is
idle.  The split route spreads the landmarks over blocks instead, one
64-landmark chunk a block, ceil(m/16)·ceil(dv/64)·ceil(c/64) blocks of
CUDA-core work at two blocks an SM; it is taken while that grid is at most
two waves (≤ 4 × 132 blocks).  Past that its time grows with m while the
tensor-core route's stays one block's walk until its own grid fills the
card.  At c = 512, dv = 256 the split route takes m ≤ 256 (a decode step,
m = 16: 8 chunks × 4 column slices = 32 blocks); both routes timed side by
side in ``chip_smoke.py`` cross between m = 256 and 512.  The tensor-core
route also needs Q's rows and address 16-byte aligned (TMA); other Q go
split, at any m (their runs then hold several chunks each).  Both
routes take any m, c, d, dv (ragged edges masked in the kernels, nothing
padded), read ``offset`` on the card (no sync), keep the sign-preserving
floor, and give identical bits for identical calls; negating U1 negates the
output exactly.

Dispatch is by the device of the tensors: CPU tensors run the plain version
(``landmark_read_plain``, the oracle of ``ref``); CUDA tensors launch a
route through ``landmark_read_cuda`` or raise — there is no fallback.
``landmark_read_cuda.launches`` counts the reads, ``.launches_tc`` and
``.launches_split`` each route's (bumped where the route launches and
nowhere else).

``landmark_read_op`` is the custom op ``repro_torch::landmark_read`` that
``ops`` calls: its CUDA kernel widens mixed dtypes to f32 and launches
``landmark_read_cuda``, its CPU kernel is the plain version and its fake
kernel gives the output's shape alone (a trace on ``meta``).  Its FLOP
formula (``landmark_flops``) counts the scores, 2·m·c·d, and the read,
2·m·c·(dv + 1) with the denominator.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.utils.flop_counter

from repro_torch.kernels.landmark_attention.ref import inv_sqrt_d
from repro_torch.kernels.landmark_attention.ref import \
    landmark_read as landmark_read_plain  # noqa: F401  (the plain version)

#: dtypes the kernels read Q, k_land and UV in, and write out in
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: the tensor-core route's block: query rows, UV columns
TC_ROWS, TC_COLS = 128, 128
#: the split route's block: query rows, landmarks of a chunk, UV columns
SPLIT_ROWS, SPLIT_CHUNK, SPLIT_COLS = 16, 64, 64
ROUTES = ("tc", "split")

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tma_loadable(Q: torch.Tensor) -> bool:
    """Q's rows and address are 16-byte aligned (what TMA loads)."""
    return (Q.shape[1] * Q.element_size()) % 16 == 0 and \
        Q.data_ptr() % 16 == 0


def tensor_core_route(m: int, c: int, dv: int, sms: int) -> bool:
    """The split route's grid at one 64-landmark chunk a block,
    ceil(m/16)·ceil(dv/64)·ceil(c/64) blocks, would take more than two
    waves of two blocks on each of the ``sms`` SMs."""
    return _cdiv(m, SPLIT_ROWS) * _cdiv(dv, SPLIT_COLS) * \
        _cdiv(c, SPLIT_CHUNK) > 4 * sms


def split_runs(m: int, c: int, dv: int, sms: int) -> Tuple[int, int]:
    """(chunks a run, runs) of the split route: enough landmark runs that
    the grid holds about two blocks an SM, each run of whole 64-landmark
    chunks."""
    chunks = _cdiv(c, SPLIT_CHUNK)
    blocks = _cdiv(m, SPLIT_ROWS) * _cdiv(dv, SPLIT_COLS)
    want = max(1, min(chunks, _cdiv(2 * sms, blocks)))
    per = _cdiv(chunks, want)
    return per, _cdiv(chunks, per)


def landmark_passes(bf16: bool, product: str) -> int:
    """The tensor-core passes of the read, as the built library reports
    them: of the scores Q·k_landᵀ (``product="scores"``) or of the
    numerator P·UV (``"values"``); 3 and 3 for f32 inputs (split TF32), 1
    and 1 for bf16."""
    from repro_torch.kernels.landmark_attention import build
    which = {"scores": 0, "values": 1}[product]
    return int(build.load_library().landmark_passes(int(bool(bf16)), which))


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
                       out_dtype: Optional[torch.dtype] = None,
                       route: Optional[str] = None) -> torch.Tensor:
    """Launch one route of the read; raises on anything it does not take.
    ``offset`` is a one-element f32 tensor on the card, read there (no
    sync); ``out_dtype`` defaults to Q's.  ``route`` ("tc" or "split")
    forces a route, to hold the two against each other; by default the
    shape picks it (``tensor_core_route``, ``tma_loadable``)."""
    out_dtype = Q.dtype if out_dtype is None else out_dtype
    _check(Q, k_land, UV, U1, offset, out_dtype)
    if route is not None and route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES} (got {route!r})")
    m, d = Q.shape
    c, dv = UV.shape
    if route == "tc" and not tma_loadable(Q):
        raise ValueError("the tensor-core route needs Q's rows and address "
                         "16-byte aligned (TMA)")
    out = torch.empty((m, dv), dtype=out_dtype, device=Q.device)
    if m == 0 or dv == 0:
        return out
    sms = torch.cuda.get_device_properties(Q.device).multi_processor_count
    if route is None:
        route = "tc" if tma_loadable(Q) and \
            tensor_core_route(m, c, dv, sms) else "split"
    from repro_torch.kernels.landmark_attention import build
    lib = build.load_library()
    bf16 = int(Q.dtype == torch.bfloat16)
    if route == "tc":
        nbytes = lib.landmark_tc_workspace_bytes(c, d, dv, bf16)
    else:
        per, runs = split_runs(m, c, dv, sms)
        nbytes = lib.landmark_split_workspace_bytes(m, dv, runs)
    ws = torch.empty((nbytes,), dtype=torch.uint8, device=Q.device)
    ptrs = [ctypes.c_void_p(X.data_ptr())
            for X in (Q, k_land, UV, U1, offset, out, ws)]
    tail = (int(out_dtype == torch.bfloat16), inv_sqrt_d(d), eps,
            Q.device.index or 0,
            ctypes.c_void_p(torch.cuda.current_stream(Q.device).cuda_stream))
    if route == "tc":
        code = lib.landmark_read_tc(*ptrs, ws.numel(), m, c, d, dv, bf16,
                                    *tail)
    else:
        code = lib.landmark_read_split(*ptrs, ws.numel(), m, c, d, dv, per,
                                       bf16, *tail)
    if code != 0:
        msg = lib.landmark_error_string(code).decode()
        raise RuntimeError(f"landmark_read ({route}) launch failed: error "
                           f"{code} ({msg})")
    landmark_read_cuda.launches += 1
    if route == "tc":
        landmark_read_cuda.launches_tc += 1
    else:
        landmark_read_cuda.launches_split += 1
    return out


landmark_read_cuda.launches = 0
landmark_read_cuda.launches_tc = 0
landmark_read_cuda.launches_split = 0


def launch_counts() -> dict:
    """Reads launched since the last reset (``landmark_read``), and of each
    route (``landmark_read_tc``, ``landmark_read_split``)."""
    return {"landmark_read": landmark_read_cuda.launches,
            "landmark_read_tc": landmark_read_cuda.launches_tc,
            "landmark_read_split": landmark_read_cuda.launches_split}


def reset_launch_counts() -> None:
    landmark_read_cuda.launches = 0
    landmark_read_cuda.launches_tc = 0
    landmark_read_cuda.launches_split = 0


# ---------------------------------------------------------------------------
# the custom op: what a dispatcher mode (a FLOP counter, an op recorder, a
# trace on ``meta``) sees as one call
# ---------------------------------------------------------------------------

def landmark_flops(q_shape, k_shape, uv_shape) -> int:
    """B5's work: the (m, c) scores at 2·d FLOPs each, then P·UV and P·U1
    at 2·(dv + 1) FLOPs a score."""
    m, d = q_shape
    c, dv = k_shape[0], uv_shape[1]
    return 2 * m * c * d + 2 * m * c * (dv + 1)


@torch.library.custom_op("repro_torch::landmark_read", mutates_args=())
def landmark_read_op(Q: torch.Tensor, k_land: torch.Tensor, UV: torch.Tensor,
                     U1: torch.Tensor, offset: torch.Tensor,
                     eps: float) -> torch.Tensor:
    # dispatched by device: the CPU kernel below, the CUDA one after it
    raise NotImplementedError(f"landmark_read on {Q.device}")


@landmark_read_op.register_kernel("cpu")
def _landmark_cpu(Q, k_land, UV, U1, offset, eps):
    return landmark_read_plain(Q, k_land, UV, U1, offset, eps)


@landmark_read_op.register_kernel("cuda")
def _landmark_cuda(Q, k_land, UV, U1, offset, eps):
    out_dtype = Q.dtype
    f32 = torch.float32
    if not (Q.dtype == k_land.dtype == UV.dtype
            and Q.dtype in KERNEL_DTYPES):
        # the kernel reads one input dtype; widening to f32 is exact and is
        # what the plain version does to each operand
        Q, k_land, UV = Q.to(f32), k_land.to(f32), UV.to(f32)
    return landmark_read_cuda(
        Q.contiguous(), k_land.contiguous(), UV.contiguous(),
        U1.to(f32).contiguous(), offset, eps, out_dtype)


@landmark_read_op.register_fake
def _landmark_fake(Q, k_land, UV, U1, offset, eps):
    return Q.new_empty((Q.shape[0], UV.shape[1]))


@torch.utils.flop_counter.register_flop_formula(
    torch.ops.repro_torch.landmark_read)
def _landmark_flop_formula(q_shape, k_shape, uv_shape, u1_shape, off_shape,
                           eps, *args, out_shape=None, **kwargs) -> int:
    return landmark_flops(q_shape, k_shape, uv_shape)
