"""Leverage scores and the pseudo-inverse (port of ``repro.core.leverage``;
the blocked-Gram variants and coherence come with the selection slice)."""
from __future__ import annotations

from typing import Optional

import torch

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
