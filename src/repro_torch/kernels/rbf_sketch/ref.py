"""Plain oracle of the fused RBF kernels (port of
``repro.kernels.rbf_sketch.ref``): the textbook formulas, every block
materialized (small shapes only), f32 throughout."""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def rbf_block(Xr: torch.Tensor, Xc: torch.Tensor,
              sigma: float) -> torch.Tensor:
    """K[ri, cj] = exp(−‖x_ri − x_cj‖² / (2σ²))."""
    Xr = Xr.to(torch.float32)
    Xc = Xc.to(torch.float32)
    rr = torch.sum(Xr * Xr, dim=1)
    cc = torch.sum(Xc * Xc, dim=1)
    sq = torch.clamp(rr[:, None] + cc[None, :] - 2.0 * (Xr @ Xc.T), min=0.0)
    gamma = 1.0 / (2.0 * sigma ** 2)
    return torch.exp(-gamma * sq)


def rbf_matmat(X: torch.Tensor, V: torch.Tensor,
               sigma: float) -> torch.Tensor:
    """K(X, X) @ V."""
    return rbf_block(X, X, sigma) @ V.to(torch.float32)


def rbf_matmat_multi(X: torch.Tensor, Vs: Sequence[torch.Tensor],
                     sigma: float):
    """[K(X, X) @ V for V in Vs]."""
    K = rbf_block(X, X, sigma)
    return tuple(K @ V.to(torch.float32) for V in Vs)


def rbf_matmat_multi_rows(Xr: torch.Tensor, Xc: torch.Tensor,
                          Vs: Sequence[torch.Tensor], sigma: float):
    """[K(Xr, Xc) @ V for V in Vs]."""
    K = rbf_block(Xr, Xc, sigma)
    return tuple(K @ V.to(torch.float32) for V in Vs)


def sketched_gram(Xs: torch.Tensor, sigma: float,
                  scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SᵀKS for a column-selection sketch: rows Xs = X[idx]."""
    blk = rbf_block(Xs, Xs, sigma)
    if scales is not None:
        blk = blk * (scales[:, None] * scales[None, :])
    return blk
