"""Public entry points of the pairwise kernels (port of
``repro.kernels.pairwise.ops``).

Arbitrary shapes go straight to the kernels, which mask their own ragged
edges: nothing is padded to the 128-wide TPU tiles.  Inputs are made f32 and
contiguous here; the device of the inputs picks the route (plain version on
the CPU, CUDA kernel on the card, see ``kernel``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels.pairwise import kernel as _k
from repro_torch.kernels.pairwise.specs import KernelSpec


def _f32(X: torch.Tensor) -> torch.Tensor:
    return X.to(torch.float32).contiguous()


def kernel_block(spec: KernelSpec, Xr: torch.Tensor, Xc: torch.Tensor,
                 edges: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K block entry_fn(stat(x_r, x_c)) of shape (len(Xr), len(Xc)).

    ``edges`` (a sign-split table) opts l1dist statistics into the
    sign-split form; other statistics ignore it.
    """
    return _k.pairwise_block(spec, _f32(Xr), _f32(Xc), edges)


def kernel_matmat_multi_rows(spec: KernelSpec, Xr: torch.Tensor,
                             Xc: torch.Tensor, Vs: Sequence[torch.Tensor],
                             edges: Optional[torch.Tensor] = None):
    """[K(Xr, Xc) @ V for V in Vs] in one launch — the rectangular row-slab
    fusion the sweep engine and ``cross`` use."""
    return _k.pairwise_matmat_multi(spec, _f32(Xr), _f32(Xc),
                                    tuple(_f32(V) for V in Vs), edges)


def kernel_matmat_multi_slab(spec: KernelSpec, X: torch.Tensor, start_row,
                             slab_len: int, Vs: Sequence[torch.Tensor],
                             edges: Optional[torch.Tensor] = None):
    """[K(X[start:start+slab_len], X) @ V for V in Vs] without gathering.

    The sharded sweep's per-shard launch: the slab is addressed inside the
    launch, so no rank materializes a row copy of X.  Rows at indices ≥ n
    (a tail slab) are duplicates of the last row; callers mask them (the
    sweep engine's validity mask does).
    """
    return _k.pairwise_matmat_multi_slab(spec, _f32(X), int(start_row),
                                         int(slab_len),
                                         tuple(_f32(V) for V in Vs), edges)


def kernel_matmat_multi(spec: KernelSpec, X: torch.Tensor,
                        Vs: Sequence[torch.Tensor],
                        edges: Optional[torch.Tensor] = None):
    """[K(X, X) @ V for V in Vs] with each kernel tile built on chip: the
    square case of ``kernel_matmat_multi_rows``."""
    return kernel_matmat_multi_rows(spec, X, X, Vs, edges)


def kernel_matmat(spec: KernelSpec, X: torch.Tensor, V: torch.Tensor,
                  edges: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K(X, X) @ V (V may be 1-D)."""
    squeeze = V.ndim == 1
    V2 = V[:, None] if squeeze else V
    (out,) = kernel_matmat_multi(spec, X, (V2,), edges)
    return out[:, 0] if squeeze else out


def sketched_gram(spec: KernelSpec, Xs: torch.Tensor,
                  scales: Optional[torch.Tensor] = None,
                  edges: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SᵀKS for a column sketch S given the selected points Xs = X[idx]."""
    blk = kernel_block(spec, Xs, Xs, edges)
    if scales is not None:
        blk = blk * (scales[:, None] * scales[None, :])
    return blk
