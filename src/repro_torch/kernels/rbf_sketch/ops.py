"""RBF wrappers over the pairwise kernels (port of
``repro.kernels.rbf_sketch.ops``).

Each binds the registry's ``rbf`` spec onto
``repro_torch.kernels.pairwise.ops``, so a call is the pairwise launch it
names: on CUDA tensors the block kernel (B2) or the fused
multi-right-hand-side kernel (B1), counted as theirs; on CPU tensors their
plain versions.  The route follows the tensors' device, as everywhere in
the port, so the reference's ``use_pallas`` switch has no counterpart.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels.pairwise import ops as _pw
from repro_torch.kernels.pairwise.specs import rbf as _rbf_spec


def rbf_block(Xr: torch.Tensor, Xc: torch.Tensor,
              sigma: float) -> torch.Tensor:
    """K-block exp(−‖x_r − x_c‖² / 2σ²) of shape (len(Xr), len(Xc))."""
    return _pw.kernel_block(_rbf_spec(sigma), Xr, Xc)


def rbf_matmat(X: torch.Tensor, V: torch.Tensor,
               sigma: float) -> torch.Tensor:
    """K(X, X) @ V fused: K is built tile by tile and never written out
    (V may be 1-D)."""
    return _pw.kernel_matmat(_rbf_spec(sigma), X, V)


def rbf_matmat_multi_rows(Xr: torch.Tensor, Xc: torch.Tensor,
                          Vs: Sequence[torch.Tensor], sigma: float):
    """[K(Xr, Xc) @ V for V in Vs]: the rectangular row-slab fusion."""
    return _pw.kernel_matmat_multi_rows(_rbf_spec(sigma), Xr, Xc, Vs)


def rbf_matmat_multi(X: torch.Tensor, Vs: Sequence[torch.Tensor],
                     sigma: float):
    """[K(X, X) @ V for V in Vs] with each kernel tile built once."""
    return _pw.kernel_matmat_multi(_rbf_spec(sigma), X, Vs)


def sketched_gram(Xs: torch.Tensor, sigma: float,
                  scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SᵀKS for a column sketch S given the selected points Xs = X[idx]."""
    return _pw.sketched_gram(_rbf_spec(sigma), Xs, scales=scales)
