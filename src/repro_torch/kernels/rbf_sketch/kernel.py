"""RBF bindings of the pairwise kernels (port of
``repro.kernels.rbf_sketch.kernel``).

The fused RBF kernels are the ``rbf`` spec of the pairwise kernels
(``repro_torch.kernels.pairwise.kernel``): on CUDA tensors these launch the
block kernel (B2) and the fused multi-right-hand-side kernel (B1), on CPU
tensors their plain versions.  The names keep the reference's ``_padded``
suffix, but the port's kernels mask their own ragged edges, so every
function here takes any shape: nothing needs padding to a tile multiple.
Inputs must be float32 tensors on one device.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels.pairwise import kernel as _pk
from repro_torch.kernels.pairwise.specs import rbf as _rbf_spec


def rbf_block_padded(Xr: torch.Tensor, Xc: torch.Tensor,
                     sigma: float) -> torch.Tensor:
    """exp(−‖x_r − x_c‖² / 2σ²) as an (nr, nc) block, one block launch;
    any shape."""
    return _pk.pairwise_block(_rbf_spec(sigma), Xr, Xc)


def rbf_matmat_multi_padded(Xr: torch.Tensor, Xc: torch.Tensor,
                            Vs: Sequence[torch.Tensor],
                            sigma: float) -> Tuple[torch.Tensor, ...]:
    """[K(Xr, Xc) @ V for V in Vs] in one fused launch; any shape."""
    return _pk.pairwise_matmat_multi(_rbf_spec(sigma), Xr, Xc, tuple(Vs))


def rbf_matmat_padded(Xr: torch.Tensor, Xc: torch.Tensor, V: torch.Tensor,
                      sigma: float) -> torch.Tensor:
    """K(Xr, Xc) @ V in one fused launch; any shape (V is 2-D)."""
    (out,) = _pk.pairwise_matmat_multi(_rbf_spec(sigma), Xr, Xc, (V,))
    return out
