"""State carried across from the reference.

The system has no weights: its state is the data, the kernel spec and the
random draws.  These helpers build the port's objects from numpy arrays (as
the reference's arrays convert with ``np.asarray``), so both sides compute
the same thing from the same numbers.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import sketch as sk
from repro_torch.core.kernelop import PairwiseKernel
from repro_torch.core.sketched_attention import LandmarkState
from repro_torch.core.spsd import SPSDApprox
from repro_torch.device import resolve_device
from repro_torch.kernels.pairwise import specs


def operator_from_reference(X: np.ndarray, spec_name: str,
                            params: Optional[dict] = None,
                            precision: str = "f32", device=None,
                            use_kernel: bool = True) -> PairwiseKernel:
    """``PairwiseKernel`` over the reference's data and spec parameters (a
    reference spec's ``dict(spec.params)`` passes as ``params``)."""
    spec = specs.get_spec(spec_name, **(params or {})).with_precision(
        precision)
    return PairwiseKernel(np.array(X, np.float32), spec,
                          use_kernel=use_kernel, device=device)


def sketch_from_reference(kind: str, n: int, *, mat=None, indices=None,
                          scales=None, device=None):
    """The reference's sketch draws as a port sketch: ``mat`` (n × s, already
    divided by sqrt(s)) for ``kind="gaussian"``; ``indices`` and ``scales``
    for ``"uniform"``/``"leverage"`` column sketches."""
    device = resolve_device(device)
    if kind == "gaussian":
        return sk.GaussianSketch(torch.as_tensor(np.array(mat, np.float32),
                                                 device=device))
    if kind in ("uniform", "leverage"):
        return sk.ColumnSketch(
            torch.as_tensor(np.array(indices, np.int64), device=device),
            torch.as_tensor(np.array(scales, np.float32), device=device),
            n)
    raise ValueError(f"sketch_from_reference: unsupported kind {kind!r}")


def approx_from_reference(C, U, P_indices=None, device=None) -> SPSDApprox:
    """A reference ``SPSDApprox`` (C, U, P_indices) as the port's."""
    device = resolve_device(device)
    P = None if P_indices is None else torch.as_tensor(
        np.array(P_indices, np.int64), device=device)
    return SPSDApprox(
        C=torch.as_tensor(np.array(C, np.float32), device=device),
        U=torch.as_tensor(np.array(U, np.float32), device=device),
        P_indices=P)


def landmark_state_from_reference(k_land, UV, U1, scale, device=None):
    """A reference ``LandmarkState`` (k_land, UV, U1, scale as numpy) as
    the port's, in f32 (bf16 values widen exactly)."""
    device = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    return LandmarkState(k_land=f32(k_land), UV=f32(UV), U1=f32(U1),
                         scale=f32(scale).reshape(()))
