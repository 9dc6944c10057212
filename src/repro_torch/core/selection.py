"""Streaming column-selection policies (port of ``repro.core.selection``).

A ``SelectionPolicy`` declares its kernel-access budget (``rounds``,
``sweeps_per_round``, ``gathers``) and picks ``c`` distinct column indices
through the operator protocol.  The port keeps its own registry; this slice
registers ``uniform`` (0 sweeps, 0 gathers).  ``leverage`` and
``uniform_adaptive2`` come with the selection slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.kernelop import as_operator
from repro_torch.device import generator_or_default


class SelectionPolicy:
    """Protocol: pick ``c`` column indices of a square SPSD operator."""

    name: str = "?"
    rounds: int = 1
    sweeps_per_round: int = 0
    gathers: int = 0

    def sweep_budget(self) -> int:
        """Total declared panel-engine sweeps for one ``select`` call."""
        return self.rounds * self.sweeps_per_round

    def select(self, K, c: int, *, generator: Optional[torch.Generator] = None,
               block_size: Optional[int] = None,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Return ``c`` distinct column indices of ``K`` (mask-aware)."""
        raise NotImplementedError


def _uniform_indices(n: int, count: int, mask: Optional[torch.Tensor],
                     generator: torch.Generator) -> torch.Tensor:
    """Uniform sampling without replacement, restricted to ``mask``'s valid
    rows when given."""
    if mask is None:
        return torch.randperm(n, generator=generator,
                              device=generator.device)[:count]
    m = mask.to(torch.float32).to(generator.device)
    return torch.multinomial(m / torch.sum(m), count, replacement=False,
                             generator=generator)


@dataclasses.dataclass
class UniformPolicy(SelectionPolicy):
    """Uniform sampling without replacement — 0 sweeps, 0 gathers."""

    name: str = "uniform"
    rounds: int = 1
    sweeps_per_round: int = 0
    gathers: int = 0

    def select(self, K, c, *, generator=None, block_size=None, mask=None):
        Kop = as_operator(K)
        idx = _uniform_indices(Kop.n, c, mask,
                               generator_or_default(generator))
        return idx.to(Kop.device)


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
    return tuple(sorted(_POLICIES))


register_policy("uniform")(UniformPolicy)
