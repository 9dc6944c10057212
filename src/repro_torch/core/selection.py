"""Streaming column-selection policies (port of ``repro.core.selection``).

A ``SelectionPolicy`` declares its kernel-access budget (``rounds``,
``sweeps_per_round``, ``gathers``) and picks ``c`` distinct column indices
through the operator protocol (``columns`` gathers and panel-engine
``sweep``s, never ``full()``).  The port keeps its own registry:

=================  ======  ===============  ========  =======================
policy             rounds  sweeps / round   gathers   selection rule
=================  ======  ===============  ========  =======================
uniform            1       0                0         uniform w/o replacement
leverage           1       0                1 pilot   p_i ∝ approx leverage of
                                                      a uniform n×p pilot
                                                      panel (blocked Gram)
uniform_adaptive2  2       1                2         round 0 uniform, then
                                                      p_j ∝ residual column
                                                      norms (one
                                                      ``ProjResidualColNorm``
                                                      sweep per round)
=================  ======  ===============  ========  =======================

Every policy samples without replacement and zeroes already-selected
indices between adaptive rounds, so index sets are duplicate-free; ``mask``
restricts selection to the valid rows of a padded operator; ``mesh``
shards every sweep the policy makes.  Randomness comes from an explicit
``torch.Generator``: draws are made on the generator's device and the
indices moved to the operator's.  On a mesh every rank must seed its
generator alike: the all-reduced statistics are the same on every rank, so
the ranks draw the same indices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import sweep as sweep_lib
from repro_torch.core.kernelop import as_operator
from repro_torch.core.leverage import row_leverage_scores_gram
from repro_torch.device import generator_or_default

_F32 = torch.float32


class SelectionPolicy:
    """Protocol: pick ``c`` column indices of a square SPSD operator.

    Subclasses declare their kernel-access budget — ``rounds``,
    ``sweeps_per_round`` and ``gathers`` (n×c ``columns`` gathers beyond
    the C panel the caller extracts) — and meet it exactly
    (``CountingOperator`` meters it).
    """

    name: str = "?"
    rounds: int = 1
    sweeps_per_round: int = 0
    gathers: int = 0

    def sweep_budget(self) -> int:
        """Total declared panel-engine sweeps for one ``select`` call."""
        return self.rounds * self.sweeps_per_round

    def select(self, K, c: int, *, generator: Optional[torch.Generator] = None,
               block_size: Optional[int] = None, mesh=None,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Return ``c`` distinct column indices of ``K`` (mask-aware)."""
        raise NotImplementedError

    def select_pair(self, K, c: int, r: int, *,
                    generator: Optional[torch.Generator] = None,
                    block_size: Optional[int] = None, mesh=None,
                    mask: Optional[torch.Tensor] = None):
        """Two independent index sets from one call (CUR's C and R sides).

        The default is two ``select`` calls (2× the declared budget), the
        C side drawn first.  Policies whose scores serve both sides of a
        symmetric operator (leverage) share the scoring pass.
        """
        g = generator_or_default(generator)
        kw = dict(generator=g, block_size=block_size, mesh=mesh, mask=mask)
        return self.select(K, c, **kw), self.select(K, r, **kw)


def _uniform_indices(n: int, count: int, mask: Optional[torch.Tensor],
                     generator: torch.Generator) -> torch.Tensor:
    """Uniform sampling without replacement, restricted to ``mask``'s valid
    rows when given."""
    if mask is None:
        return torch.randperm(n, generator=generator,
                              device=generator.device)[:count]
    m = mask.to(_F32).to(generator.device)
    return torch.multinomial(m / torch.sum(m), count, replacement=False,
                             generator=generator)


def _weighted_indices_without_replacement(
        weights: torch.Tensor, count: int, allowed: torch.Tensor,
        generator: torch.Generator) -> torch.Tensor:
    """Sample ``count`` distinct indices with p ∝ ``weights`` on ``allowed``.

    Disallowed indices get exactly zero probability.  The reference's
    relative floor 1e-9·max + 1e-30 on the allowed set keeps the support
    from collapsing below ``count`` (weights that are exactly zero once C
    spans the column space fall back to uniform over the allowed set) —
    ``torch.multinomial`` without replacement raises when fewer than
    ``count`` weights are positive.
    """
    allowed = allowed.to(_F32)
    w = torch.clamp(weights.to(_F32), min=0.0) * allowed
    floor = (1e-9 * torch.max(w) + 1e-30) * allowed
    p = (w + floor).to(generator.device)
    return torch.multinomial(p / torch.sum(p), count, replacement=False,
                             generator=generator)


@dataclasses.dataclass
class UniformPolicy(SelectionPolicy):
    """Uniform sampling without replacement — 0 sweeps, 0 gathers."""

    name: str = "uniform"
    rounds: int = 1
    sweeps_per_round: int = 0
    gathers: int = 0

    def select(self, K, c, *, generator=None, block_size=None, mesh=None,
               mask=None):
        Kop = as_operator(K)
        idx = _uniform_indices(Kop.n, c, mask,
                               generator_or_default(generator))
        return idx.to(Kop.device)


@dataclasses.dataclass
class LeveragePolicy(SelectionPolicy):
    """Approximate-leverage column sampling from a uniform pilot panel.

    A uniform pilot of ``p = min(n, max(2c, c + oversample))`` columns is
    gathered (ONE n×p ``columns`` call — the only kernel access), its row
    leverage scores come from the blocked Gram pass
    (``row_leverage_scores_gram``), and ``c`` columns are drawn without
    replacement with p_i ∝ those scores.  Sweep budget 0: the Gram and
    quadratic-form passes stream over the pilot panel, not over K.  Under a
    ``mask`` the pilot is clamped to the valid count, so it never holds a
    padding column.
    """

    name: str = "leverage"
    rounds: int = 1
    sweeps_per_round: int = 0
    gathers: int = 1
    pilot: Optional[int] = None     # pilot panel width (default max(2c, c+8))
    oversample: int = 8

    def _pilot_scores(self, Kop, c: int, mask, block_size, generator,
                      mesh=None) -> torch.Tensor:
        """Approximate leverage scores from one uniform n×p pilot gather."""
        n = Kop.n
        p = self.pilot if self.pilot is not None else max(2 * c,
                                                          c + self.oversample)
        p = min(n, int(p))
        if mask is not None:
            p = min(p, int(torch.sum(mask)))
        pilot_idx = _uniform_indices(n, p, mask, generator).to(Kop.device)
        Cp = Kop.columns(pilot_idx)
        if mask is not None:
            Cp = Cp * mask.to(Cp.dtype)[:, None]
        return row_leverage_scores_gram(Cp, block_size=block_size, mesh=mesh)

    @staticmethod
    def _allowed(n: int, mask, device) -> torch.Tensor:
        return torch.ones((n,), dtype=_F32, device=device) if mask is None \
            else mask.to(device=device, dtype=_F32)

    def select(self, K, c, *, generator=None, block_size=None, mesh=None,
               mask=None):
        Kop = as_operator(K)
        g = generator_or_default(generator)
        lev = self._pilot_scores(Kop, c, mask, block_size, g, mesh)
        idx = _weighted_indices_without_replacement(
            lev, c, self._allowed(Kop.n, mask, lev.device), g)
        return idx.to(Kop.device)

    def select_pair(self, K, c, r, *, generator=None, block_size=None,
                    mesh=None, mask=None):
        """Both CUR sides from ONE pilot: for an SPSD operator the pilot
        panel's row and column leverage agree."""
        Kop = as_operator(K)
        g = generator_or_default(generator)
        lev = self._pilot_scores(Kop, max(c, r), mask, block_size, g, mesh)
        allowed = self._allowed(Kop.n, mask, lev.device)
        return (_weighted_indices_without_replacement(lev, c, allowed,
                                                      g).to(Kop.device),
                _weighted_indices_without_replacement(lev, r, allowed,
                                                      g).to(Kop.device))


def _masked_orthonormal_basis(C: torch.Tensor) -> torch.Tensor:
    """Left singular vectors of C with zero-σ columns zeroed out, so Q Qᵀ is
    the orthogonal projector onto range(C) even when C is rank-deficient."""
    u, s, _ = torch.linalg.svd(C.to(_F32), full_matrices=False)
    eps = float(torch.finfo(_F32).eps)
    cutoff = max(C.shape) * eps * torch.max(s)
    return u * (s > cutoff).to(_F32)[None, :]


def residual_column_norms(Kop, idx: torch.Tensor,
                          block_size: Optional[int] = None, mesh=None,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """||(I − C C†) K||² column norms in ONE panel sweep (adaptive rounds).

    ``mask`` row-masks both the C panel and the sweep statistics, so padded
    operators never leak padding rows into the norms.
    """
    C = Kop.columns(idx)                       # n·c entries, not a sweep
    if mask is not None:
        C = C * mask.to(C.dtype)[:, None]
    Q = _masked_orthonormal_basis(C)
    (norms,) = Kop.sweep([sweep_lib.ProjResidualColNormPlan(Q, mask)],
                         block_size=block_size, mesh=mesh)
    return norms


@dataclasses.dataclass
class UniformAdaptive2Policy(SelectionPolicy):
    """uniform + adaptive² (Wang, Luo, Zhang 2016): round 0 uniform, then
    ``adaptive_rounds`` rounds with p_j ∝ the squared residual column norms
    of the running sketch — ONE panel sweep and one C gather per adaptive
    round.  Already-selected indices get zero probability and every round
    samples without replacement.
    """

    name: str = "uniform_adaptive2"
    sweeps_per_round: int = 1
    adaptive_rounds: int = 2

    @property
    def rounds(self) -> int:            # sweep-costing rounds == adaptive ones
        return self.adaptive_rounds

    @property
    def gathers(self) -> int:           # one C gather per adaptive round
        return self.adaptive_rounds

    def select(self, K, c, *, generator=None, block_size=None, mesh=None,
               mask=None):
        Kop = as_operator(K)
        g = generator_or_default(generator)
        extra = c // (self.adaptive_rounds + 1)
        if extra == 0:
            # degrading to pure uniform would break the declared
            # sweep_budget() every metered caller relies on
            raise ValueError(
                f"uniform_adaptive2 needs c ≥ {self.adaptive_rounds + 1} so "
                f"each adaptive round draws at least one column (got c={c}); "
                f"use selection='uniform' for smaller sketches")
        c0 = c - self.adaptive_rounds * extra
        idx = _uniform_indices(Kop.n, c0, mask, g).to(Kop.device)
        for _ in range(self.adaptive_rounds):
            norms = residual_column_norms(Kop, idx, block_size=block_size,
                                          mesh=mesh, mask=mask)
            # sized to the rows THIS round's sweep saw (the operator may
            # have grown between rounds)
            n = int(norms.shape[0])
            valid = torch.ones((n,), dtype=_F32, device=norms.device) \
                if mask is None else mask.to(device=norms.device, dtype=_F32)
            selected = torch.zeros((n,), dtype=_F32, device=norms.device)
            selected[idx.to(norms.device)] = 1.0
            new = _weighted_indices_without_replacement(
                norms, extra, valid * (1.0 - selected), g)
            idx = torch.cat([idx, new.to(Kop.device)])
        return idx


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_POLICIES: Dict[str, Callable[..., SelectionPolicy]] = {}


def register_policy(name: str):
    """Decorator: register a ``SelectionPolicy`` factory under ``name``."""
    def deco(factory: Callable[..., SelectionPolicy]):
        _POLICIES[name] = factory
        return factory
    return deco


def get_policy(policy, **params) -> SelectionPolicy:
    """Resolve a policy name (or pass a ``SelectionPolicy`` through)."""
    if isinstance(policy, SelectionPolicy):
        return policy
    if policy not in _POLICIES:
        raise ValueError(f"unknown selection policy {policy!r}; registered: "
                         f"{registered_policies()}")
    return _POLICIES[policy](**params)


def registered_policies() -> Tuple[str, ...]:
    """Registered policy names, sorted."""
    return tuple(sorted(_POLICIES))


register_policy("uniform")(UniformPolicy)
register_policy("leverage")(LeveragePolicy)
register_policy("uniform_adaptive2")(UniformAdaptive2Policy)
