"""Matrix sketching operators (port of ``repro.core.sketch``).

Five families: uniform and leverage column sampling, Gaussian projection,
SRHT and CountSketch.  A sketch S ∈ R^{n×s} exposes ``left`` (SᵀA),
``right`` (A S) and ``sym`` (SᵀKS); column sketches also expose their
indices so SPSD code reads blocks of an implicit kernel matrix.

Random draws come from an explicit ``torch.Generator`` (on the generator's
device, then moved to the target device).  Every sketch can also be built
from explicit numbers — ``ColumnSketch(indices, scales, n)``,
``GaussianSketch(mat)`` — which is how tests hand the reference's draws to
the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.device import generator_or_default, resolve_device

_F32 = torch.float32


# ---------------------------------------------------------------------------
# Column selection sketches (one nonzero per column of S)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ColumnSketch:
    """S with S[i_j, j] = scale_j (Eq. 1).  ``indices``: (s,),
    ``scales``: (s,)."""

    indices: torch.Tensor
    scales: torch.Tensor
    n: int

    @property
    def s(self) -> int:
        return int(self.indices.shape[0])

    def left(self, A: torch.Tensor) -> torch.Tensor:     # Sᵀ A
        return A[self.indices.to(A.device)] * \
            self.scales.to(A.device)[:, None]

    def right(self, A: torch.Tensor) -> torch.Tensor:    # A S
        return A[:, self.indices.to(A.device)] * \
            self.scales.to(A.device)[None, :]

    def sym(self, K: torch.Tensor) -> torch.Tensor:      # Sᵀ K S
        idx = self.indices.to(K.device)
        sc = self.scales.to(K.device)
        return K[idx][:, idx] * (sc[:, None] * sc[None, :])


def uniform_column_sketch(n: int, s: int, scale: bool = True,
                          mask: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          device=None) -> ColumnSketch:
    """Uniform sampling without replacement (p_i = 1/n, or 1/n_valid on the
    rows of ``mask``); raises when s exceeds the valid rows."""
    device = resolve_device(device)
    g = generator_or_default(generator)
    if mask is None:
        idx = torch.randperm(n, generator=g, device=g.device)[:s]
        one = math.sqrt(n / s) if scale else 1.0
    else:
        m = mask.to(_F32)
        nv = int(torch.sum(m).item())
        if nv < s:
            raise ValueError(
                f"uniform_column_sketch: s={s} exceeds the {nv} valid rows "
                f"of the mask; sampling without replacement would pull in "
                f"padding rows")
        idx = torch.multinomial(m.to(g.device), s, replacement=False,
                                generator=g)
        one = math.sqrt(nv / s) if scale else 1.0
    sc = torch.full((s,), one, dtype=_F32, device=device)
    return ColumnSketch(idx.to(device), sc, n)


def leverage_column_sketch(lev: torch.Tensor, s: int, scale: bool = False,
                           generator: Optional[torch.Generator] = None
                           ) -> ColumnSketch:
    """Leverage-score sampling with replacement, p_i ∝ lev_i (Algorithm 2).
    Default is the paper's §4.5 unscaled variant; ``scale=True`` gives
    1/sqrt(s·p_i)."""
    g = generator_or_default(generator)
    n = lev.shape[0]
    p = lev.to(_F32) / torch.sum(lev.to(_F32))
    idx = torch.multinomial(p.to(g.device), s, replacement=True,
                            generator=g).to(lev.device)
    if scale:
        sc = 1.0 / torch.sqrt(s * p[idx])
    else:
        sc = torch.ones((s,), dtype=_F32, device=lev.device)
    return ColumnSketch(idx, sc.to(_F32), n)


def subset_union_sketch(base: ColumnSketch, extra_indices: torch.Tensor,
                        n: int) -> ColumnSketch:
    """Enforce P ⊂ S (Corollary 5): prepend the P indices with scale 1."""
    dev = base.indices.device
    extra = torch.as_tensor(extra_indices, dtype=torch.int64, device=dev)
    idx = torch.cat([extra, base.indices])
    sc = torch.cat([torch.ones((extra.shape[0],), dtype=_F32, device=dev),
                    base.scales.to(dev)])
    return ColumnSketch(idx, sc, n)


# ---------------------------------------------------------------------------
# Gaussian projection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GaussianSketch:
    """S = G/sqrt(s), G_ij ~ N(0,1), held as its (n × s) matrix ``mat``
    (already divided by sqrt(s)) — the same O(n·s) as the K S it feeds."""

    mat: torch.Tensor

    @classmethod
    def draw(cls, n: int, s: int, generator: Optional[torch.Generator] = None,
             device=None) -> "GaussianSketch":
        g = generator_or_default(generator)
        G = torch.randn((n, s), generator=g, dtype=_F32,
                        device=g.device)
        return cls((G / math.sqrt(s)).to(resolve_device(device)))

    @property
    def n(self) -> int:
        return int(self.mat.shape[0])

    @property
    def s(self) -> int:
        return int(self.mat.shape[1])

    def _mat(self) -> torch.Tensor:
        return self.mat

    def left(self, A: torch.Tensor) -> torch.Tensor:     # Sᵀ A : (s, d)
        return self.mat.to(A.dtype).T @ A

    def right(self, A: torch.Tensor) -> torch.Tensor:    # A S : (m, s)
        return A @ self.mat.to(A.dtype)

    def sym(self, K: torch.Tensor) -> torch.Tensor:
        S = self.mat.to(K.dtype)
        return S.T @ K @ S


# ---------------------------------------------------------------------------
# SRHT
# ---------------------------------------------------------------------------

def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized fast Walsh-Hadamard transform along axis 0 (length a
    power of 2): H_n @ x with ±1 entries."""
    n = x.shape[0]
    rest = tuple(x.shape[1:])
    h = 1
    y = x
    while h < n:
        y = y.reshape((n // (2 * h), 2, h) + rest)
        a = y[:, 0]
        b = y[:, 1]
        y = torch.stack([a + b, a - b], dim=1)
        h *= 2
    return y.reshape((n,) + rest)


@dataclasses.dataclass
class SRHTSketch:
    """S = sqrt(n/s)·(1/sqrt(n))·D H P (paper §3.1.2), n zero-padded to the
    next power of two."""

    signs: torch.Tensor       # (n_pad,)
    indices: torch.Tensor     # (s,) rows kept after the transform
    n: int

    @property
    def s(self) -> int:
        return int(self.indices.shape[0])

    def left(self, A: torch.Tensor) -> torch.Tensor:
        n_pad = self.signs.shape[0]
        pad_shape = (n_pad - A.shape[0],) + tuple(A.shape[1:])
        Ap = torch.cat([A, torch.zeros(pad_shape, dtype=A.dtype,
                                       device=A.device)])
        signs = self.signs.to(A.device, A.dtype)
        y = fwht(signs.reshape((-1,) + (1,) * (A.ndim - 1)) * Ap)
        y = y / math.sqrt(n_pad)
        y = y[self.indices.to(A.device)]
        return y * math.sqrt(n_pad / self.s)

    def right(self, A: torch.Tensor) -> torch.Tensor:
        return self.left(A.T).T

    def sym(self, K: torch.Tensor) -> torch.Tensor:
        return self.left(self.left(K).T).T


def _rademacher(shape, g: torch.Generator) -> torch.Tensor:
    bits = torch.randint(0, 2, shape, generator=g, device=g.device)
    return (2 * bits - 1).to(_F32)


def rademacher(n: int, m: int, generator: Optional[torch.Generator] = None,
               device=None) -> torch.Tensor:
    """(n × m) f32 ±1 draws (Hutchinson probes)."""
    g = generator_or_default(generator)
    return _rademacher((n, m), g).to(resolve_device(device))


def srht_sketch(n: int, s: int, generator: Optional[torch.Generator] = None,
                device=None) -> SRHTSketch:
    device = resolve_device(device)
    g = generator_or_default(generator)
    n_pad = _next_pow2(n)
    signs = _rademacher((n_pad,), g)
    idx = torch.randperm(n_pad, generator=g, device=g.device)[:s]
    return SRHTSketch(signs.to(device), idx.to(device), n)


# ---------------------------------------------------------------------------
# CountSketch
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CountSketch:
    """One ±1 per row of S; SᵀA is a signed segment sum, O(nnz(A))."""

    hashes: torch.Tensor   # (n,) in [0, s)
    signs: torch.Tensor    # (n,) ±1
    s: int

    @property
    def n(self) -> int:
        return int(self.hashes.shape[0])

    def left(self, A: torch.Tensor) -> torch.Tensor:
        signed = A * self.signs.to(A.device, A.dtype).reshape(
            (-1,) + (1,) * (A.ndim - 1))
        out = torch.zeros((self.s,) + tuple(A.shape[1:]), dtype=A.dtype,
                          device=A.device)
        return out.index_add(0, self.hashes.to(A.device), signed)

    def right(self, A: torch.Tensor) -> torch.Tensor:
        return self.left(A.T).T

    def sym(self, K: torch.Tensor) -> torch.Tensor:
        return self.left(self.left(K).T).T


def count_sketch(n: int, s: int, generator: Optional[torch.Generator] = None,
                 device=None) -> CountSketch:
    device = resolve_device(device)
    g = generator_or_default(generator)
    hashes = torch.randint(0, s, (n,), generator=g, device=g.device)
    signs = _rademacher((n,), g)
    return CountSketch(hashes.to(device), signs.to(device), s)


# ---------------------------------------------------------------------------
# Row masking (ragged / padded batches)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MaskedSketch:
    """diag(mask) · S — a sketch restricted to the valid rows of a padded
    operator, so SᵀMKMS never touches a padding entry."""

    base: object
    mask: torch.Tensor      # (n,) 1.0 on valid rows, 0.0 on padding

    @property
    def n(self) -> int:
        return self.base.n

    @property
    def s(self) -> int:
        return self.base.s

    def left(self, A: torch.Tensor) -> torch.Tensor:     # Sᵀ M A
        m = self.mask.to(A.device, A.dtype)
        return self.base.left(A * m.reshape((-1,) + (1,) * (A.ndim - 1)))

    def right(self, A: torch.Tensor) -> torch.Tensor:    # A M S
        m = self.mask.to(A.device, A.dtype)
        return self.base.right(A * m[None, :])

    def sym(self, K: torch.Tensor) -> torch.Tensor:      # Sᵀ M K M S
        m = self.mask.to(K.device, K.dtype)
        return self.base.sym(K * (m[:, None] * m[None, :]))


# ---------------------------------------------------------------------------
# Streaming application against implicit operators
# ---------------------------------------------------------------------------

def plan_for_sketch(S):
    """K S as a panel plan: Gaussian sketches as their matrix (a
    ``MatmulPlan``, so a fused launch can take them), every other family as
    ``S.right`` per panel."""
    from repro_torch.core import sweep as sweep_lib
    base, mask = (S.base, S.mask) if isinstance(S, MaskedSketch) else (S, None)
    if isinstance(base, GaussianSketch):
        M = base._mat()
        if mask is not None:
            M = M * mask.to(M.device, M.dtype)[:, None]
        return sweep_lib.MatmulPlan(M)
    return sweep_lib.SketchRightPlan(S, S.s)


def right_streaming(S, Kop, block_size: Optional[int] = None,
                    mesh=None) -> torch.Tensor:
    """K S (n × s) in one sweep of the panel engine (sharded over
    ``mesh``)."""
    (KS,) = Kop.sweep([plan_for_sketch(S)], block_size=block_size, mesh=mesh)
    return KS


def sym_streaming(S, Kop, block_size: Optional[int] = None,
                  mesh=None) -> torch.Tensor:
    """SᵀKS via a streamed K S then one ``S.left``."""
    return S.left(right_streaming(S, Kop, block_size, mesh=mesh))


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------

SKETCH_KINDS = ("uniform", "leverage", "gaussian", "srht", "countsketch")


def make_sketch(kind: str, n: int, s: int,
                lev: Optional[torch.Tensor] = None, scale: bool = False,
                generator: Optional[torch.Generator] = None, device=None):
    """Build any of the paper's five sketches (Table 4 row names)."""
    if kind == "uniform":
        return uniform_column_sketch(n, s, scale=scale, generator=generator,
                                     device=device)
    if kind == "leverage":
        if lev is None:
            raise ValueError("leverage sketch needs leverage scores")
        return leverage_column_sketch(lev, s, scale=scale,
                                      generator=generator)
    if kind == "gaussian":
        return GaussianSketch.draw(n, s, generator=generator, device=device)
    if kind == "srht":
        return srht_sketch(n, s, generator=generator, device=device)
    if kind == "countsketch":
        return count_sketch(n, s, generator=generator, device=device)
    raise ValueError(f"unknown sketch kind {kind!r}; one of {SKETCH_KINDS}")
