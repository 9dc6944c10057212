"""Leverage scores, coherence and the pseudo-inverse (port of
``repro.core.leverage``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.sweep import GramPlan, RowQuadFormPlan, sweep_panels

_EPS_F32 = float(torch.finfo(torch.float32).eps)


def _default_rcond(shape) -> float:
    """numpy-style cutoff max(m, n)·eps(f32), the reference's rule."""
    return max(shape) * _EPS_F32


def row_leverage_scores(A: torch.Tensor,
                        rcond: Optional[float] = None) -> torch.Tensor:
    """l_i = ||u_i:||² of the thin SVD A = U Σ Vᵀ, singular values below
    rcond·σ_max masked; the scores sum to rank(A)."""
    rcond = _default_rcond(A.shape) if rcond is None else rcond
    u, s, _ = torch.linalg.svd(A.to(torch.float32), full_matrices=False)
    mask = (s > rcond * torch.max(s)).to(torch.float32)
    return torch.sum((u * mask[None, :]) ** 2, dim=1)


def column_leverage_scores(A: torch.Tensor,
                           rcond: Optional[float] = None) -> torch.Tensor:
    return row_leverage_scores(A.T, rcond)


def _gram_leverage(panel_fn, nrows: int, dim: int, block_size, device,
                   mesh=None):
    """l_i = p_i (Σ panelsᵀ panels)† p_iᵀ over (b × dim) panels: a blocked
    Gram pass then a blocked quadratic-form pass through the sweep engine —
    peak memory O(b·dim + dim²), sharded over ``mesh``."""
    (G,) = sweep_panels(panel_fn, nrows, dim, [GramPlan(dim)],
                        block_size=block_size, device=device, mesh=mesh)
    W = pinv(0.5 * (G + G.T))
    (lev,) = sweep_panels(panel_fn, nrows, dim, [RowQuadFormPlan(W)],
                          block_size=block_size, device=device, mesh=mesh)
    return lev


def row_leverage_scores_gram(A: torch.Tensor,
                             block_size: Optional[int] = None,
                             mesh=None) -> torch.Tensor:
    """Row leverage scores of a tall A (m × c) via a blocked Gram AᵀA pass:
    l_i = a_i (AᵀA)† a_iᵀ, with no transposed copy or SVD workspace of A."""
    m, cdim = A.shape
    return _gram_leverage(lambda idx: A[idx], m, cdim, block_size, A.device,
                          mesh)


def column_leverage_scores_gram(R: torch.Tensor,
                                block_size: Optional[int] = None,
                                mesh=None) -> torch.Tensor:
    """Column leverage scores of a wide R (r × n), streamed: l_j =
    R_:jᵀ (R Rᵀ)† R_:j, the Gram accumulated over (b × r) column panels."""
    r, n = R.shape
    return _gram_leverage(lambda idx: R[:, idx].T, n, r, block_size,
                          R.device, mesh)


def row_coherence(A: torch.Tensor) -> torch.Tensor:
    """mu(A) = (m / rank) · max_i l_i, in [1, m]."""
    lev = row_leverage_scores(A)
    return A.shape[0] / torch.sum(lev) * torch.max(lev)


def pinv(A: torch.Tensor, rcond: Optional[float] = None) -> torch.Tensor:
    """Moore-Penrose inverse via an f32 SVD (small s×c / c×c blocks), with
    the reference's cutoff rcond·σ_max, rcond = max(m, n)·eps(f32)."""
    rcond = _default_rcond(A.shape) if rcond is None else rcond
    u, s, vt = torch.linalg.svd(A.to(torch.float32), full_matrices=False)
    cutoff = rcond * torch.max(s)
    sinv = torch.where(s > cutoff, 1.0 / s, torch.zeros_like(s))
    return (vt.T * sinv[None, :]) @ u.T


def orthonormal_basis(A: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of range(A) (Algorithm 1, optional step 3)."""
    u, _, _ = torch.linalg.svd(A.to(torch.float32), full_matrices=False)
    return u
