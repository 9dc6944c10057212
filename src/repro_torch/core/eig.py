"""Downstream solvers on C U Cᵀ (port of ``repro.core.eig``, paper
Appendix A).

With (C, U) at hand the k-eigendecomposition costs O(nc²) and the
regularized solve O(nc²).  ``streaming_subspace_eigh`` is the exact-eigvec
reference on an operator: every application of K streams through
``matmat`` sweeps (sharded over ``mesh``).  Eigenvectors are defined up to
sign (and rotation inside repeated eigenvalues): compare subspaces, e.g.
with ``misalignment``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.kernelop import as_operator
from repro_torch.device import generator_or_default

_F32 = torch.float32


class EigResult(NamedTuple):
    eigenvalues: torch.Tensor    # (k,) descending
    eigenvectors: torch.Tensor   # (n, k) orthonormal


def approx_eigh(C: torch.Tensor, U: torch.Tensor, k: int,
                dtype: torch.dtype = _F32) -> EigResult:
    """Lemma 10: eigendecomposition of C U Cᵀ in O(nc²), in ``dtype``.

    C = U_C Σ_C V_Cᵀ;  Z = (Σ_C V_Cᵀ) U (Σ_C V_Cᵀ)ᵀ = V_Z Λ V_Zᵀ;
    then C U Cᵀ = (U_C V_Z) Λ (U_C V_Z)ᵀ.
    """
    Uc, sc, Vct = torch.linalg.svd(C.to(dtype), full_matrices=False)
    SV = sc[:, None] * Vct
    M = SV @ U.to(dtype) @ SV.T
    M = 0.5 * (M + M.T)
    lam, Vz = torch.linalg.eigh(M)                   # ascending
    lam, Vz = torch.flip(lam, dims=(0,)), torch.flip(Vz, dims=(1,))
    vecs = Uc @ Vz
    return EigResult(eigenvalues=lam[:k], eigenvectors=vecs[:, :k])


def woodbury_solve(C: torch.Tensor, U: torch.Tensor, alpha: float,
                   y: torch.Tensor) -> torch.Tensor:
    """Lemma 11: solve (C U Cᵀ + α Iₙ) w = y in O(nc²), in the inverse-free
    form α U (α I + Cᵀ C U)⁻¹, so a singular U is fine.

    ``alpha`` must be a finite positive ridge (the identity divides by it)
    and ``U`` SPSD.
    """
    a = float(alpha)
    if not (a > 0.0) or a == float("inf"):
        raise ValueError(
            f"woodbury_solve: alpha must be a finite positive ridge, got "
            f"{a!r}; the Woodbury identity divides by alpha and would "
            f"silently return NaN")
    C32, U32, y32 = C.to(_F32), U.to(_F32), y.to(_F32)
    c = C32.shape[1]
    eye = torch.eye(c, dtype=_F32, device=C32.device)
    # M = (α U⁻¹ + Cᵀ C)⁻¹ = U (α I + Cᵀ C U)⁻¹
    inner = a * eye + (C32.T @ C32) @ U32
    M = U32 @ torch.linalg.solve(inner, eye)
    return (y32 - C32 @ (M @ (C32.T @ y32))) / a


def kpca_features(C: torch.Tensor, U: torch.Tensor,
                  k: int) -> Tuple[torch.Tensor, EigResult]:
    """§6.3 KPCA: train features Λ^{1/2} Vᵀ, returned as (n, k)."""
    eig = approx_eigh(C, U, k)
    lam = torch.clamp(eig.eigenvalues, min=0.0)
    return eig.eigenvectors * torch.sqrt(lam)[None, :], eig


def kpca_transform(eig: EigResult, k_x: torch.Tensor) -> torch.Tensor:
    """Test features Λ^{-1/2} Vᵀ k(x) for kernel column(s) k_x (n, b)."""
    lam = torch.clamp(eig.eigenvalues, min=1e-12)
    return (eig.eigenvectors.T @ k_x) / torch.sqrt(lam)[:, None]


def misalignment(U_true: torch.Tensor, V_approx: torch.Tensor
                 ) -> torch.Tensor:
    """Eq. 10: (1/k)||U_k − Ṽ Ṽᵀ U_k||_F² ∈ [0, 1]."""
    k = U_true.shape[1]
    d = U_true - V_approx @ (V_approx.T @ U_true)
    return torch.sum(d * d) / k


def streaming_subspace_eigh(K, k: int, oversample: int = 8,
                            power_iters: int = 6,
                            block_size: Optional[int] = None, mesh=None,
                            Omega=None,
                            generator: Optional[torch.Generator] = None
                            ) -> EigResult:
    """Top-k eigenpairs of an SPSD operator by randomized subspace iteration
    (Halko–Martinsson–Tropp): ``power_iters + 2`` streamed ``matmat``
    sweeps, the n×n kernel never formed.  ``Omega`` (n × min(n, k +
    oversample)) passes the Gaussian start; otherwise it is drawn from
    ``generator``.
    """
    Kop = as_operator(K)
    q = min(Kop.n, k + oversample)
    if Omega is None:
        g = generator_or_default(generator)
        Omega = torch.randn((Kop.n, q), generator=g, dtype=_F32,
                            device=g.device)
    Omega = torch.as_tensor(Omega, dtype=_F32, device=Kop.device)
    Y = Kop.matmat(Omega, block_size=block_size, mesh=mesh)
    for _ in range(power_iters):
        Qb, _ = torch.linalg.qr(Y)
        Y = Kop.matmat(Qb, block_size=block_size, mesh=mesh)
    Qb, _ = torch.linalg.qr(Y)
    B = Qb.T @ Kop.matmat(Qb, block_size=block_size, mesh=mesh)
    B = 0.5 * (B + B.T)
    lam, W = torch.linalg.eigh(B)                    # ascending
    lam, W = torch.flip(lam, dims=(0,)), torch.flip(W, dims=(1,))
    return EigResult(eigenvalues=lam[:k], eigenvectors=(Qb @ W)[:, :k])


def spectral_embedding(C: torch.Tensor, U: torch.Tensor, k: int,
                       eps: float = 1e-9,
                       degrees: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """§6.4: normalized-Laplacian top-k eigenvectors from C U Cᵀ ≈ K, rows
    normalized.  d = C U Cᵀ 1 unless ``degrees`` gives exact degree sums
    (one streamed ``matmat`` on the kernel operator)."""
    ones = torch.ones((C.shape[0], 1), dtype=C.dtype, device=C.device)
    d = (C @ (U @ (C.T @ ones)))[:, 0] if degrees is None \
        else degrees.to(C.dtype)
    dinv = 1.0 / torch.sqrt(torch.clamp(d, min=eps))
    eig = approx_eigh(C * dinv[:, None], U, k)
    V = eig.eigenvectors
    return V / torch.clamp(torch.linalg.norm(V, dim=1, keepdim=True),
                           min=eps)
