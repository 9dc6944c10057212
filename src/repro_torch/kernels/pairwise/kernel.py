"""The pairwise kernels: CUDA wrappers, their plain PyTorch versions, and
launch counters (port of ``repro.kernels.pairwise.kernel``).

Three kernels, hand-written in CUDA C++ for Hopper's tensor cores
(``csrc/pairwise_wgmma.cu``):

- ``pairwise_block(spec, Xr, Xc)`` — the explicit block
  ``entry_fn(stat(Xr, Xc))`` (replaces ``pairwise_block_padded``);
- ``pairwise_matmat_multi(spec, Xr, Xc, Vs)`` — ``[K(Xr, Xc) @ V for V in
  Vs]`` with K built tile by tile on chip and never written out (replaces
  ``pairwise_matmat_multi_padded``).  The right-hand sides are concatenated
  column-wise into one operand, so one launch serves every V;
- ``pairwise_matmat_multi_slab(spec, X, start_row, slab_len, Vs)`` — the
  same on the row slab ``X[start_row : start_row + slab_len]`` of the
  shared X, addressed inside the launch with no row copy (replaces
  ``pairwise_matmat_multi_slab``, the sharded sweep's per-shard launch).
  Rows at or past n read the last row (clamp padding the caller masks).

Each takes any shapes: the kernels mask their own ragged edges, so nothing
is padded to 128.  Dispatch is by the device of the tensors: CPU tensors
run the plain version (``*_plain``, the same arithmetic in PyTorch); CUDA
tensors launch the kernel through ``*_cuda`` or raise — there is no
fallback.  ``*_cuda.launches`` counts the launches (a plain int bumped where
the kernel is launched and nowhere else).

A built-in spec passes its epilogue to the built-in library.  A spec with
only a Python ``entry_fn`` is lowered once (``lower.program_for``) and
launched from its user variant of the same kernels
(``build.user_library``) with the ``EPI_USER`` epilogue, counted like any other
launch.  An entry that cannot be lowered raises ``ValueError`` naming the
op; a failed build or launch raises too.

``edges`` (a sign-split table) selects the sign-split form of the l1
statistic in the plain version; the CUDA kernels sum |x_k − y_k| directly,
which is the same function on data inside the plan.

Each CUDA launch also takes a scratch buffer the wrapper allocates
(``_workspace``): the points in the kernels' operand form (TF32 parts or
bf16, with their squared norms; f32 sqdist keeps the f32 values too) and,
for a sweep, Vᵀ's parts.

Under the f32 policy the kernels' sqdist is the tensor cores' (xx + yy) −
2 x·y, except where that is below ``NEAR_TAU`` (xx + yy): there the
combine's rounding at the scale of the norms would dominate, so those near
pairs are summed again directly, Σ (x_k − y_k)² in feature order with each
point read as its TF32 parts hi + lo (``csrc/pairwise_wgmma.cu``
``sq_near``).  The plain version keeps the reference's combine.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.pairwise import lower
from repro_torch.kernels.pairwise import specs as _specs
from repro_torch.kernels.pairwise.specs import KernelSpec

_STAT_IDS = _specs.STAT_IDS
#: the CUDA kernels' id of the user epilogue (``EPI_USER`` in
#: csrc/pairwise_wgmma.cu); a built-in epilogue's id is its index in
#: ``specs.EPILOGUE_KINDS``
EPI_USER = 5
#: the f32 kernels evaluate a sqdist entry directly where the combine is
#: below NEAR_TAU (‖x‖² + ‖y‖²) (``NEAR_TAU`` in csrc/pairwise_wgmma.cu)
NEAR_TAU = 0.25


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the comparison the card is held to)
# ---------------------------------------------------------------------------

def pairwise_block_plain(spec: KernelSpec, Xr: torch.Tensor,
                         Xc: torch.Tensor,
                         edges: Optional[torch.Tensor] = None) -> torch.Tensor:
    """entry_fn(stat(Xr, Xc)) as an (nr, nc) f32 block."""
    return _specs.apply(spec, Xr, Xc, edges)


def pairwise_matmat_multi_plain(spec: KernelSpec, Xr: torch.Tensor,
                                Xc: torch.Tensor, Vs: Sequence[torch.Tensor],
                                edges: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, ...]:
    """[K(Xr, Xc) @ V for V in Vs] with K and V quantized to the spec's tile
    dtype and f32 accumulation (``_contract_tile`` of the reference)."""
    dt = spec.tile_dtype()
    K = _specs.apply(spec, Xr, Xc, edges).to(dt).to(torch.float32)
    return tuple(K @ V.to(dt).to(torch.float32) for V in Vs)


def slab_rows(n: int, start_row: int, slab_len: int,
              device=None) -> torch.Tensor:
    """The data rows a slab reads: ``start_row + i`` clamped to n − 1."""
    rows = start_row + torch.arange(slab_len, dtype=torch.int64,
                                    device=device)
    return torch.clamp(rows, max=n - 1)


def pairwise_matmat_multi_slab_plain(spec: KernelSpec, X: torch.Tensor,
                                     start_row: int, slab_len: int,
                                     Vs: Sequence[torch.Tensor],
                                     edges: Optional[torch.Tensor] = None
                                     ) -> Tuple[torch.Tensor, ...]:
    """[K(X[rows], X) @ V for V in Vs] with ``rows = slab_rows(...)``: the
    clamped rows gathered, then ``pairwise_matmat_multi_plain``."""
    rows = slab_rows(X.shape[0], start_row, slab_len, X.device)
    return pairwise_matmat_multi_plain(spec, X[rows], X, Vs, edges)


# ---------------------------------------------------------------------------
# argument checks shared by both paths
# ---------------------------------------------------------------------------

def _check_points(Xr: torch.Tensor, Xc: torch.Tensor,
                  edges: Optional[torch.Tensor]) -> None:
    for name, X in (("Xr", Xr), ("Xc", Xc)):
        if not isinstance(X, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if X.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 (got {X.dtype})")
        if X.ndim != 2:
            raise ValueError(f"{name} must be 2-D (got shape "
                             f"{tuple(X.shape)})")
    if Xr.shape[1] != Xc.shape[1]:
        raise ValueError(f"feature dims differ: {Xr.shape[1]} vs "
                         f"{Xc.shape[1]}")
    if Xr.device != Xc.device:
        raise ValueError(f"Xr on {Xr.device} but Xc on {Xc.device}")
    if edges is not None:
        if edges.dtype != torch.float32 or edges.ndim != 2 or \
                edges.shape[0] != Xr.shape[1]:
            raise ValueError(f"edges must be float32 (d, B-1) with d = "
                             f"{Xr.shape[1]} (got {edges.dtype} "
                             f"{tuple(edges.shape)})")
        if edges.device != Xr.device:
            raise ValueError(f"edges on {edges.device} but points on "
                             f"{Xr.device}")


def _check_rhs(Xc: torch.Tensor, Vs: Sequence[torch.Tensor]) -> None:
    for V in Vs:
        if not isinstance(V, torch.Tensor) or V.dtype != torch.float32:
            raise TypeError("every right-hand side must be a float32 tensor")
        if V.ndim != 2 or V.shape[0] != Xc.shape[0]:
            raise ValueError(f"right-hand side of shape {tuple(V.shape)} "
                             f"does not match nc = {Xc.shape[0]}")
        if V.device != Xc.device:
            raise ValueError(f"right-hand side on {V.device} but points on "
                             f"{Xc.device}")


def _check_slab(X: torch.Tensor, start_row, slab_len) -> Tuple[int, int]:
    start_row, slab_len = int(start_row), int(slab_len)
    if start_row < 0 or slab_len < 0:
        raise ValueError(f"slab start {start_row} and length {slab_len} must "
                         f"be ≥ 0")
    if X.shape[0] == 0:
        raise ValueError("a slab needs n ≥ 1 data rows")
    return start_row, slab_len


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _epilogue(spec: KernelSpec):
    """The library to launch and the epilogue arguments to pass (id, a, b,
    degree): the built-in library and the spec's epilogue, or for a spec
    with only a Python ``entry_fn`` its lowered program's user variant and
    ``EPI_USER``.  Lowering happens here, before any other check
    (``ValueError`` naming the op); the library is built at its first
    ``load()``."""
    from repro_torch.kernels.pairwise import build
    ep = spec.epilogue
    if ep is not None:
        return build.LIBRARY, (ep.id, ep.a, ep.b, ep.degree)
    return build.user_library(lower.program_for(spec), spec.stat), \
        (EPI_USER, 0.0, 0.0, 0)


def _check_cuda(*tensors: torch.Tensor) -> None:
    for X in tensors:
        if X.device.type != "cuda":
            raise ValueError(f"the CUDA kernel takes CUDA tensors (got a "
                             f"tensor on {X.device})")
        if not X.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous row-major "
                             "tensors")


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.pairwise_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _workspace(lib, nr: int, nc: int, d: int, M: int, spec: KernelSpec,
               same: bool, device: torch.device) -> torch.Tensor:
    """The scratch bytes one launch needs (its size from the library)."""
    nbytes = lib.pairwise_workspace_bytes(
        nr, nc, d, M, _STAT_IDS[spec.stat],
        int(spec.precision == "bf16_f32acc"), int(same))
    return torch.empty((nbytes,), dtype=torch.uint8, device=device)


def _ptr(X: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(X.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def pairwise_block_cuda(spec: KernelSpec, Xr: torch.Tensor, Xc: torch.Tensor,
                        edges: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the block kernel; raises on anything it does not take."""
    library, epi = _epilogue(spec)
    _check_points(Xr, Xc, edges)
    _check_cuda(Xr, Xc)
    nr, d = Xr.shape
    nc = Xc.shape[0]
    if d == 0:
        raise ValueError("the CUDA kernel needs d ≥ 1 features")
    out = torch.empty((nr, nc), dtype=torch.float32, device=Xr.device)
    if nr == 0 or nc == 0:
        return out
    lib = library.load()
    ws = _workspace(lib, nr, nc, d, 0, spec, False, Xr.device)
    code = lib.pairwise_block_f32(
        _ptr(Xr), _ptr(Xc), _ptr(out), nr, nc, d, _STAT_IDS[spec.stat],
        *epi, int(spec.precision == "bf16_f32acc"),
        _ptr(ws), ws.numel(), Xr.device.index or 0, _stream(Xr.device))
    _raise_on(lib, code, "pairwise_block")
    pairwise_block_cuda.launches += 1
    return out


pairwise_block_cuda.launches = 0


def pairwise_matmat_multi_cuda(spec: KernelSpec, Xr: torch.Tensor,
                               Xc: torch.Tensor, Vs: Sequence[torch.Tensor],
                               edges: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, ...]:
    """Launch the fused multi-right-hand-side kernel once for all ``Vs``;
    raises on anything it does not take."""
    library, epi = _epilogue(spec)
    _check_points(Xr, Xc, edges)
    Vs = tuple(Vs)
    _check_rhs(Xc, Vs)
    _check_cuda(Xr, Xc)
    nr, d = Xr.shape
    nc = Xc.shape[0]
    widths = [int(V.shape[1]) for V in Vs]
    M = sum(widths)
    if d == 0:
        raise ValueError("the CUDA kernel needs d ≥ 1 features")
    if nr == 0 or nc == 0 or M == 0:
        return tuple(torch.zeros((nr, m), dtype=torch.float32,
                                 device=Xr.device) for m in widths)
    V = Vs[0] if len(Vs) == 1 else torch.cat(Vs, dim=1)
    _check_cuda(V)
    out = torch.empty((nr, M), dtype=torch.float32, device=Xr.device)
    lib = library.load()
    # keys that are the rows are prepped once; this one decision sizes the
    # scratch and is passed to the library, which checks both
    same = Xr.data_ptr() == Xc.data_ptr() and nr == nc
    ws = _workspace(lib, nr, nc, d, M, spec, same, Xr.device)
    code = lib.pairwise_matmat_multi_f32(
        _ptr(Xr), _ptr(Xc), _ptr(V), _ptr(out), nr, nc, d, M, int(same),
        _STAT_IDS[spec.stat], *epi,
        int(spec.precision == "bf16_f32acc"), _ptr(ws), ws.numel(),
        Xr.device.index or 0, _stream(Xr.device))
    _raise_on(lib, code, "pairwise_matmat_multi")
    pairwise_matmat_multi_cuda.launches += 1
    return tuple(torch.split(out, widths, dim=1))


pairwise_matmat_multi_cuda.launches = 0


def pairwise_matmat_multi_slab_cuda(spec: KernelSpec, X: torch.Tensor,
                                    start_row: int, slab_len: int,
                                    Vs: Sequence[torch.Tensor],
                                    edges: Optional[torch.Tensor] = None
                                    ) -> Tuple[torch.Tensor, ...]:
    """Launch the slab kernel once for all ``Vs``: rows ``start_row + i``
    (clamped to n − 1) of X against all of X.  Raises on anything it does
    not take."""
    library, epi = _epilogue(spec)
    _check_points(X, X, edges)
    start_row, slab_len = _check_slab(X, start_row, slab_len)
    Vs = tuple(Vs)
    _check_rhs(X, Vs)
    _check_cuda(X)
    n, d = X.shape
    widths = [int(V.shape[1]) for V in Vs]
    M = sum(widths)
    if d == 0:
        raise ValueError("the CUDA kernel needs d ≥ 1 features")
    if slab_len == 0 or M == 0:
        return tuple(torch.zeros((slab_len, m), dtype=torch.float32,
                                 device=X.device) for m in widths)
    V = Vs[0] if len(Vs) == 1 else torch.cat(Vs, dim=1)
    _check_cuda(V)
    out = torch.empty((slab_len, M), dtype=torch.float32, device=X.device)
    lib = library.load()
    ws = _workspace(lib, slab_len, n, d, M, spec, False, X.device)
    code = lib.pairwise_matmat_multi_slab_f32(
        _ptr(X), _ptr(V), _ptr(out), n, start_row, slab_len, d, M,
        _STAT_IDS[spec.stat], *epi,
        int(spec.precision == "bf16_f32acc"), _ptr(ws), ws.numel(),
        X.device.index or 0, _stream(X.device))
    _raise_on(lib, code, "pairwise_matmat_multi_slab")
    pairwise_matmat_multi_slab_cuda.launches += 1
    return tuple(torch.split(out, widths, dim=1))


pairwise_matmat_multi_slab_cuda.launches = 0


# ---------------------------------------------------------------------------
# dispatch by device
# ---------------------------------------------------------------------------

def pairwise_block(spec: KernelSpec, Xr: torch.Tensor, Xc: torch.Tensor,
                   edges: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K block entry_fn(stat(Xr, Xc)): the plain version on CPU tensors, the
    CUDA kernel on CUDA tensors."""
    if Xr.device.type == "cpu":
        _check_points(Xr, Xc, edges)
        return pairwise_block_plain(spec, Xr, Xc, edges)
    return pairwise_block_cuda(spec, Xr, Xc, edges)


def pairwise_matmat_multi(spec: KernelSpec, Xr: torch.Tensor,
                          Xc: torch.Tensor, Vs: Sequence[torch.Tensor],
                          edges: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, ...]:
    """[K(Xr, Xc) @ V for V in Vs]: the plain version on CPU tensors, one
    CUDA launch on CUDA tensors."""
    if Xr.device.type == "cpu":
        _check_points(Xr, Xc, edges)
        _check_rhs(Xc, Vs)
        return pairwise_matmat_multi_plain(spec, Xr, Xc, Vs, edges)
    return pairwise_matmat_multi_cuda(spec, Xr, Xc, Vs, edges)


def pairwise_matmat_multi_slab(spec: KernelSpec, X: torch.Tensor,
                               start_row: int, slab_len: int,
                               Vs: Sequence[torch.Tensor],
                               edges: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, ...]:
    """[K(X[slab], X) @ V for V in Vs]: the plain version on CPU tensors, one
    CUDA launch on CUDA tensors."""
    if X.device.type == "cpu":
        _check_points(X, X, edges)
        start_row, slab_len = _check_slab(X, start_row, slab_len)
        _check_rhs(X, Vs)
        return pairwise_matmat_multi_slab_plain(spec, X, start_row, slab_len,
                                                Vs, edges)
    return pairwise_matmat_multi_slab_cuda(spec, X, start_row, slab_len, Vs,
                                           edges)


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the last reset."""
    return {"pairwise_block": pairwise_block_cuda.launches,
            "pairwise_matmat_multi": pairwise_matmat_multi_cuda.launches,
            "pairwise_matmat_multi_slab":
                pairwise_matmat_multi_slab_cuda.launches}


def reset_launch_counts() -> None:
    pairwise_block_cuda.launches = 0
    pairwise_matmat_multi_cuda.launches = 0
    pairwise_matmat_multi_slab_cuda.launches = 0
