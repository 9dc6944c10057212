"""Independent dense oracles for the pairwise kernels (port of
``repro.kernels.pairwise.ref``).

Written from the textbook formulas, not from ``KernelSpec.entry_fn``, so
parity tests check the spec definitions themselves.  Every oracle
materializes the whole block: small shapes only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pairwise.specs import KernelSpec


def _sq(Xr: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    Xr = Xr.to(torch.float32)
    Xc = Xc.to(torch.float32)
    rr = torch.sum(Xr * Xr, dim=1)
    cc = torch.sum(Xc * Xc, dim=1)
    return torch.clamp(rr[:, None] + cc[None, :] - 2.0 * (Xr @ Xc.T), min=0.0)


def rbf_block(Xr, Xc, sigma: float) -> torch.Tensor:
    """exp(−‖x − y‖² / (2σ²))."""
    return torch.exp(-_sq(Xr, Xc) / (2.0 * sigma ** 2))


def laplacian_block(Xr, Xc, gamma: float) -> torch.Tensor:
    """exp(−γ ‖x − y‖₁) via the full broadcast."""
    Xr = Xr.to(torch.float32)
    Xc = Xc.to(torch.float32)
    l1 = torch.sum(torch.abs(Xr[:, None, :] - Xc[None, :, :]), dim=-1)
    return torch.exp(-gamma * l1)


def matern32_block(Xr, Xc, length_scale: float) -> torch.Tensor:
    """(1 + √3 r/ℓ) exp(−√3 r/ℓ), r = ‖x − y‖₂."""
    r = torch.sqrt(_sq(Xr, Xc))
    z = (3.0 ** 0.5) * r / length_scale
    return (1.0 + z) * torch.exp(-z)


def polynomial_block(Xr, Xc, degree: int = 3, gamma=None,
                     coef0: float = 1.0) -> torch.Tensor:
    """(γ xᵀy + c)^p."""
    g = 1.0 if gamma is None else gamma
    dot = Xr.to(torch.float32) @ Xc.to(torch.float32).T
    return (g * dot + coef0) ** degree


def linear_block(Xr, Xc) -> torch.Tensor:
    """xᵀy."""
    return Xr.to(torch.float32) @ Xc.to(torch.float32).T


_ORACLES = {
    "rbf": rbf_block,
    "laplacian": laplacian_block,
    "matern32": matern32_block,
    "polynomial": polynomial_block,
    "linear": linear_block,
}


def kernel_block(spec: KernelSpec, Xr, Xc) -> torch.Tensor:
    """Dispatch to the named oracle with the spec's parameters."""
    if spec.name not in _ORACLES:
        raise KeyError(f"no ref oracle for kernel {spec.name!r}; known: "
                       f"{tuple(sorted(_ORACLES))}")
    return _ORACLES[spec.name](Xr, Xc, **dict(spec.params))


def kernel_matmat_multi_rows(spec: KernelSpec, Xr, Xc, Vs):
    """[K(Xr, Xc) @ V for V in Vs]."""
    K = kernel_block(spec, Xr, Xc)
    return tuple(K @ V.to(torch.float32) for V in Vs)
