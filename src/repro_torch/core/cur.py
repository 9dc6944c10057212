"""CUR matrix decomposition (port of ``repro.core.cur``).

Given A (m×n), C = c columns, R = r rows:

- optimal:    U* = C† A R†                              (Eq. 8)
- drineas08:  U  = (P_Rᵀ A P_C)†                        (Fig. 2c baseline)
- fast:       Ũ  = (S_Cᵀ C)† (S_Cᵀ A S_R) (R S_R)†      (Eq. 9)

plus the adaptive-sampling row selection used by Theorem 8.

``A`` is a dense matrix (a tensor, on its own device; anything else is
placed on ``device``, the CUDA device unless given) or an implicit square
``SPSDOperator`` (kernel CUR), which is never densified.  ``mesh=`` shards
every sweep (``repro_torch.distributed.sharding``).

Randomness: each randomized entry point takes a ``torch.Generator`` and the
explicit draws — ``cidx`` / ``ridx`` (the columns and rows forming C and R),
``Sc`` / ``Sr`` (the sketches: ``(indices, scales)`` before the subset
union for a column sketch, an (m, sc) / (n, sr) matrix for a Gaussian one,
or sketch objects; ``Sc`` and ``Sr`` are passed together) — so tests hand
the reference's draws to both sides.  Draws left to the generator are taken
in the order cidx, ridx, Sc, Sr.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import selection as selection_lib
from repro_torch.core import sketch as sk
from repro_torch.core import sweep as sweep_lib
from repro_torch.core.kernelop import SPSDOperator, as_operator
from repro_torch.core.leverage import (column_leverage_scores_gram, pinv,
                                       row_leverage_scores,
                                       row_leverage_scores_gram)
from repro_torch.core.spsd import _column_sketch, _projection_sketch
from repro_torch.device import generator_or_default, resolve_device

_F32 = torch.float32


def _matrix(A, device=None):
    """An operator as it is; a dense A as a tensor (kept on its device)."""
    if isinstance(A, (SPSDOperator, torch.Tensor)):
        return A
    return torch.as_tensor(A, device=resolve_device(device))


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def _shape_of(A) -> tuple:
    """(m, n) of a dense matrix or an implicit (square) ``SPSDOperator``."""
    if isinstance(A, SPSDOperator):
        return A.n, A.n
    return tuple(A.shape)


def _rows_of(A, idx: torch.Tensor) -> torch.Tensor:
    """A[idx, :] without densifying an implicit operator."""
    if isinstance(A, SPSDOperator):
        return A.block(idx, torch.arange(A.n, device=A.device))
    return A[idx]


def _cols_of(A, idx: torch.Tensor) -> torch.Tensor:
    """A[:, idx] without densifying an implicit operator."""
    if isinstance(A, SPSDOperator):
        return A.columns(idx)
    return A[:, idx]


def _block_of(A, ridx: torch.Tensor, cidx: torch.Tensor) -> torch.Tensor:
    """A[ridx][:, cidx] — an (|ridx| × |cidx|) block."""
    if isinstance(A, SPSDOperator):
        return A.block(ridx, cidx)
    return A[ridx][:, cidx]


class CURApprox(NamedTuple):
    C: torch.Tensor                              # (m, c)
    U: torch.Tensor                              # (c, r)
    R: torch.Tensor                              # (r, n)
    col_indices: Optional[torch.Tensor] = None
    row_indices: Optional[torch.Tensor] = None

    def dense(self) -> torch.Tensor:
        return self.C @ self.U @ self.R


def select_cur_sketches(A, c: int, r: int, selection="uniform",
                        block_size: int = 1024, mesh=None, cidx=None,
                        ridx=None,
                        generator: Optional[torch.Generator] = None,
                        device=None):
    """Sample the columns and rows forming C and R (the paper's §5.3 setup);
    returns ``(C, R, cidx, ridx)``.

    Only the selected m×c / r×n panels are materialized.  Non-uniform
    policies need a square (SPSD) ``A``; one ``select_pair`` call serves
    both sides, so leverage pays for its pilot once.  ``cidx`` and ``ridx``
    pass the draws.
    """
    A = _matrix(A, device)
    dev = A.device
    m, n = _shape_of(A)
    if cidx is None or ridx is None:
        g = generator_or_default(generator)
        pol = selection_lib.get_policy(selection)
        if pol.name == "uniform":
            cidx = torch.randperm(n, generator=g, device=g.device)[:c]
            ridx = torch.randperm(m, generator=g, device=g.device)[:r]
        else:
            if m != n:
                raise ValueError(
                    f"selection policy {pol.name!r} scores columns of a "
                    f"square SPSD A; got shape {(m, n)} — use "
                    f"selection='uniform' for rectangular matrices")
            cidx, ridx = pol.select_pair(as_operator(A, device=dev), c, r,
                                         generator=g, block_size=block_size,
                                         mesh=mesh)
    cidx, ridx = _index(cidx, dev), _index(ridx, dev)
    return _cols_of(A, cidx), _rows_of(A, ridx), cidx, ridx


def optimal_U(A: torch.Tensor, C: torch.Tensor,
              R: torch.Tensor) -> torch.Tensor:
    return pinv(C) @ A.to(_F32) @ pinv(R)


def drineas08_U(A: torch.Tensor, cidx, ridx) -> torch.Tensor:
    """U = (P_Rᵀ A P_C)† — the poor-quality baseline of Fig. 2(c)."""
    cidx = torch.as_tensor(cidx, dtype=torch.int64, device=A.device)
    ridx = torch.as_tensor(ridx, dtype=torch.int64, device=A.device)
    return pinv(A[ridx][:, cidx])                 # (c, r)


def fast_U_cur(ScC: torch.Tensor, ScASr: torch.Tensor,
               RSr: torch.Tensor) -> torch.Tensor:
    """Ũ = (S_Cᵀ C)† (S_Cᵀ A S_R) (R S_R)†  (Eq. 9)."""
    return pinv(ScC) @ ScASr.to(_F32) @ pinv(RSr)


def blocked_right_sketch(A, S, block_size: int = 1024,
                         mesh=None) -> torch.Tensor:
    """A S (m × s) streamed over row panels of A through the sweep engine.

    An implicit operator routes through its own ``sweep``, so a kernel
    operator claims a Gaussian sketch with the fused launch (one slab launch
    per rank on a wide mesh).  A Gaussian sketch on a dense A is one GEMM.
    For other sketches on a dense A under a wide mesh, each rank claims its
    contiguous row slab (one ``S.right``) whenever the slab stays inside the
    panel element budget; otherwise the panels are walked.
    """
    if isinstance(A, SPSDOperator):
        return sk.right_streaming(S, A, block_size=block_size, mesh=mesh)
    if isinstance(S, sk.GaussianSketch):
        return S.right(A)
    m, n = A.shape
    plan = sweep_lib.SketchRightPlan(S, S.s)
    dp = sweep_lib.mesh_data_size(mesh)
    slab_fn = None
    if dp > 1 and sweep_lib.local_slab_rows(m, n, block_size, dp) * n \
            <= sweep_lib.PANEL_ELEMENT_BUDGET:
        def slab_fn(row_idx, valid):
            return (plan.update(plan.init(m, n, A.device), A[row_idx],
                                row_idx, valid),)
    (AS,) = sweep_lib.sweep_panels(
        lambda idx: A[idx], m, n, [plan], block_size=block_size,
        device=A.device, mesh=mesh, slab_fn=slab_fn)
    return AS


def fast_cur(
    A,
    c: int,
    r: int,
    sc: int,
    sr: int,
    sketch_kind: str = "leverage",
    enforce_subset: bool = True,
    scale: bool = False,
    streaming: bool = False,
    block_size: int = 1024,
    mesh=None,
    selection="uniform",
    cidx=None,
    ridx=None,
    Sc=None,
    Sr=None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> CURApprox:
    """End-to-end fast CUR: select C/R, then the sketched Ũ (Thm 9 setup).

    ``selection`` picks the columns and rows of C and R through the
    ``SelectionPolicy`` registry.  Column-selection sketches observe only an
    (sc × sr) block of A besides C and R; leverage sketches use the row
    scores of C (for S_C) and of Rᵀ (for S_R).  With ``streaming=True``
    (always for an operator) S_Cᵀ A S_R goes through
    ``blocked_right_sketch`` and the R-side scores through the blocked Gram
    pass.  ``mesh`` shards every sweep, selection included.
    """
    A = _matrix(A, device)
    dev = A.device
    streaming = streaming or isinstance(A, SPSDOperator)
    m, n = _shape_of(A)
    g = generator_or_default(generator)
    C, R, cidx, ridx = select_cur_sketches(
        A, c, r, selection=selection, block_size=block_size, mesh=mesh,
        cidx=cidx, ridx=ridx, generator=g)

    if sketch_kind in ("uniform", "leverage"):
        if Sc is not None and Sr is not None:
            Sc, Sr = _column_sketch(Sc, m, dev), _column_sketch(Sr, n, dev)
        elif sketch_kind == "leverage":
            if streaming:
                lev_c = row_leverage_scores_gram(C, block_size, mesh=mesh)
                lev_r = column_leverage_scores_gram(R, block_size, mesh=mesh)
            else:
                lev_c = row_leverage_scores(C)
                lev_r = row_leverage_scores(R.T)
            Sc = sk.leverage_column_sketch(lev_c, sc, scale=scale,
                                           generator=g)
            Sr = sk.leverage_column_sketch(lev_r, sr, scale=scale,
                                           generator=g)
        else:
            Sc = sk.uniform_column_sketch(m, sc, scale=scale, generator=g,
                                          device=dev)
            Sr = sk.uniform_column_sketch(n, sr, scale=scale, generator=g,
                                          device=dev)
        if enforce_subset:
            # §4.5 applied to CUR: the rows of R ⊂ S_C, the columns of C ⊂ S_R
            Sc = sk.subset_union_sketch(Sc, ridx, m)
            Sr = sk.subset_union_sketch(Sr, cidx, n)
        ScC = Sc.left(C)
        RSr = Sr.left(R.T).T
        blk = _block_of(A, Sc.indices, Sr.indices)
        ScASr = blk * (Sc.scales[:, None] * Sr.scales[None, :])
    else:
        Sc = _projection_sketch(Sc, sketch_kind, m, sc, g, dev)
        Sr = _projection_sketch(Sr, sketch_kind, n, sr, g, dev)
        ScC = Sc.left(C)
        RSr = Sr.left(R.T).T
        if streaming:
            ScASr = Sc.left(blocked_right_sketch(A, Sr, block_size,
                                                 mesh=mesh))
        else:
            ScASr = Sc.left(Sr.left(A.T).T)

    U = fast_U_cur(ScC, ScASr, RSr)
    return CURApprox(C=C, U=U, R=R, col_indices=cidx, row_indices=ridx)


def optimal_cur(A: torch.Tensor, c: int, r: int, cidx=None, ridx=None,
                generator: Optional[torch.Generator] = None,
                device=None) -> CURApprox:
    A = _matrix(A, device)
    C, R, cidx, ridx = select_cur_sketches(A, c, r, cidx=cidx, ridx=ridx,
                                           generator=generator)
    return CURApprox(C=C, U=optimal_U(A, C, R), R=R,
                     col_indices=cidx, row_indices=ridx)


# ---------------------------------------------------------------------------
# Adaptive row selection (Wang & Zhang 2013; used by Theorem 8)
# ---------------------------------------------------------------------------

def adaptive_row_probabilities(A: torch.Tensor,
                               base: torch.Tensor) -> torch.Tensor:
    """p_i ∝ the squared residual norm of row i of A against the rows
    ``base``."""
    A32 = A.to(_F32)
    R1 = A32[_index(base, A.device)]
    resid = A32 - (A32 @ pinv(R1)) @ R1
    norms = torch.sum(resid * resid, dim=1)
    return norms / torch.clamp(torch.sum(norms), min=1e-30)


def adaptive_row_indices(A: torch.Tensor, base, extra: int, idx=None,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """``base`` then ``extra`` rows drawn with replacement ∝ the squared
    residual norms against the rows in ``base``; ``idx`` passes the draw."""
    base = _index(base, A.device)
    if idx is None:
        g = generator_or_default(generator)
        p = adaptive_row_probabilities(A, base)
        idx = torch.multinomial(p.to(g.device), extra, replacement=True,
                                generator=g)
    return torch.cat([base, _index(idx, A.device)])


def relative_error(A: torch.Tensor, approx: CURApprox) -> torch.Tensor:
    A32 = A.to(_F32)
    Rm = A32 - approx.dense().to(_F32)
    return torch.sum(Rm * Rm) / torch.sum(A32 * A32)
