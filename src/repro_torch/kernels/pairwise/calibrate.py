"""Per-``KernelSpec`` streaming bandwidth calibration (port of
``repro.kernels.pairwise.calibrate``).

Every registered spec's entries are an elementwise function of one pairwise
statistic (``sqdist`` / ``dot`` / ``l1dist``), so a quantile of that
statistic fixes the spec's scale parameter such that typical entries land in
the kernel's responsive range (the RBF "median heuristic", for every spec):

1. the statistic is exposed as an operator (``PairwiseKernel.stat_operator``:
   the spec's statistic with an identity entry function), so
2. an n × m panel of statistic values against ``m`` uniform anchor points is
   ONE ``columns`` gather — exactly n·m statistic evaluations; on the card
   one launch of the block kernel with the identity epilogue, and
3. a registered per-spec *calibration rule* maps the quantile of those values
   to the spec's parameters (σ for rbf, γ for laplacian/polynomial, ℓ for
   matern32; linear has none and skips the gather).

The port keeps a registry of its own; custom kernels register a rule next to
their spec::

    from repro_torch.kernels.pairwise import calibrate, specs

    @calibrate.register_calibration("cauchy")
    def _cal_cauchy(stat_q, base_spec):
        return specs.get_spec("cauchy", gamma=1.0 / max(stat_q, 1e-12))

    spec = calibrate.calibrate_sigma(X, spec="cauchy")
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.device import generator_or_default
from repro_torch.kernels.pairwise import specs as _specs
from repro_torch.kernels.pairwise.specs import KernelSpec

_EPS = 1e-12


def anchor_indices(generator: torch.Generator, n: int,
                   anchors: int) -> torch.Tensor:
    """Uniform without-replacement anchor columns for the statistic panel,
    drawn on the generator's device."""
    return torch.randperm(n, generator=generator,
                          device=generator.device)[:min(anchors, n)]


def quantile(values: torch.Tensor, q: float) -> torch.Tensor:
    """The q-quantile of all of ``values`` (f32 result), numpy's and
    ``jnp.quantile``'s default ``linear`` method: the sorted values at
    ⌊q·(N−1)⌋ and the next index, interpolated.

    ``torch.quantile`` refuses inputs above 2^24 elements; this has no such
    limit (one sort), and the position q·(N−1) and its fraction are
    computed in f64, so they stay exact at any N an index can reach.
    """
    flat = values.reshape(-1).to(torch.float32)
    N = int(flat.numel())
    if N == 0:
        raise ValueError("the quantile of an empty panel is undefined")
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must lie in [0, 1] (got {q})")
    pos = float(q) * (N - 1)
    lo = min(int(math.floor(pos)), N - 1)
    hi = min(lo + 1, N - 1)
    frac = pos - lo
    s = torch.sort(flat).values
    a, b = s[lo].double(), s[hi].double()
    return (a + (b - a) * frac).to(torch.float32)


def stat_quantile(stat_op, q: float = 0.5, anchors: int = 128,
                  generator: Optional[torch.Generator] = None,
                  anchor_idx=None,
                  transform: Optional[Callable] = None) -> torch.Tensor:
    """q-quantile of a statistic operator's entries against anchor columns.

    ``stat_op`` is any ``SPSDOperator`` whose entries are the raw pairwise
    statistic (``PairwiseKernel.stat_operator()``); the n × m anchor panel is
    ONE ``columns`` gather — exactly n·m statistic evaluations, never a
    full-operator sweep.  The quantile is exact over those n·m pairs;
    ``transform`` (``torch.abs`` for the signed dot statistic) is applied
    first.  Pass ``anchor_idx`` to pin the anchor set (parity tests);
    otherwise it is drawn from ``generator`` (a CPU generator seeded with
    ``DEFAULT_SEED`` when None).
    """
    if anchor_idx is None:
        anchor_idx = anchor_indices(generator_or_default(generator),
                                    stat_op.n, anchors)
    S = stat_op.columns(torch.as_tensor(anchor_idx, dtype=torch.int64,
                                        device=stat_op.device))
    if transform is not None:
        S = transform(S)
    return quantile(S, q)


@dataclasses.dataclass(frozen=True)
class CalibrationRule:
    """How a spec family turns a statistic quantile into parameters.

    ``needs_stat=False`` marks parameterless families (linear): the
    statistic gather is skipped entirely and ``apply`` receives 0.0.
    """

    apply: Callable[[float, KernelSpec], KernelSpec]
    transform: Optional[Callable] = None     # pre-quantile (abs for dot)
    needs_stat: bool = True


_RULES: Dict[str, CalibrationRule] = {}


def register_calibration(name: str, transform: Optional[Callable] = None,
                         needs_stat: bool = True):
    """Decorator: register ``fn(stat_q, base_spec) -> KernelSpec`` for the
    spec family ``name`` in the port's registry (``transform`` preprocesses
    statistic values before the quantile; ``needs_stat=False`` skips the
    gather for parameterless families)."""
    def deco(fn: Callable[[float, KernelSpec], KernelSpec]):
        _RULES[name] = CalibrationRule(apply=fn, transform=transform,
                                       needs_stat=needs_stat)
        return fn
    return deco


def registered_calibrations() -> Tuple[str, ...]:
    return tuple(sorted(_RULES))


def calibration_rule(name: str) -> CalibrationRule:
    """The registered rule of the spec family ``name``; raises if none."""
    if name not in _RULES:
        raise ValueError(
            f"no calibration rule for kernel {name!r} (registered: "
            f"{registered_calibrations()}); add one with "
            f"@register_calibration({name!r})")
    return _RULES[name]


def calibrate_sigma(X, spec="rbf", *, q: float = 0.5, anchors: int = 128,
                    generator: Optional[torch.Generator] = None,
                    anchor_idx=None, use_kernel: bool = True,
                    stat_op=None, device=None) -> KernelSpec:
    """Calibrated ``KernelSpec`` for ``spec`` from one streaming gather.

    ``spec`` is a registered name or a ``KernelSpec`` (whose non-scale
    parameters — polynomial degree/coef0 — are kept).  The spec's pairwise
    statistic is quantiled against ``anchors`` uniform anchor points in ONE
    n×m gather (``stat_quantile``) and mapped to parameters by the family's
    registered rule.  ``stat_op`` overrides the statistic operator (metered
    wrappers in tests); otherwise it is
    ``PairwiseKernel(X, stat_only(spec), use_kernel, device=device)``, on
    the CUDA device unless ``device`` names another.
    """
    base = _specs.get_spec(spec) if isinstance(spec, str) else spec
    rule = calibration_rule(base.name)
    if not rule.needs_stat:            # parameterless family: no gather
        return rule.apply(0.0, base)
    if stat_op is None:
        from repro_torch.core.kernelop import PairwiseKernel
        stat_op = PairwiseKernel(X, _specs.stat_only(base), use_kernel,
                                 device=device)
    qv = stat_quantile(stat_op, q=q, anchors=anchors, generator=generator,
                       anchor_idx=anchor_idx, transform=rule.transform)
    return rule.apply(float(qv), base)


# ---------------------------------------------------------------------------
# built-in rules: typical statistic -> O(1) argument of the entry function
# ---------------------------------------------------------------------------

@register_calibration("rbf")
def _cal_rbf(stat_q: float, base: KernelSpec) -> KernelSpec:
    """Median heuristic: σ² = q(‖x−y‖²)/2, so the typical entry is e^{-1}."""
    return _specs.get_spec("rbf", sigma=(max(stat_q, _EPS) / 2.0) ** 0.5)


@register_calibration("laplacian")
def _cal_laplacian(stat_q: float, base: KernelSpec) -> KernelSpec:
    """γ = 1/q(‖x−y‖₁): the typical L1 distance maps to entry e^{-1}."""
    return _specs.get_spec("laplacian", gamma=1.0 / max(stat_q, _EPS))


@register_calibration("matern32")
def _cal_matern32(stat_q: float, base: KernelSpec) -> KernelSpec:
    """ℓ = typical distance √q(‖x−y‖²): entry (1+√3)e^{-√3} at that range."""
    return _specs.get_spec("matern32",
                           length_scale=max(stat_q, _EPS) ** 0.5)


@register_calibration("polynomial", transform=torch.abs)
def _cal_polynomial(stat_q: float, base: KernelSpec) -> KernelSpec:
    """γ = 1/q(|xᵀy|) keeps γ·xᵀy O(1), so (γ xᵀy + c)ᵖ neither explodes nor
    collapses to cᵖ; degree and coef0 carry over from the base spec."""
    return _specs.get_spec("polynomial", degree=base.param("degree"),
                           gamma=1.0 / max(stat_q, _EPS),
                           coef0=base.param("coef0"))


@register_calibration("linear", needs_stat=False)
def _cal_linear(stat_q: float, base: KernelSpec) -> KernelSpec:
    """K = X Xᵀ has no scale parameter: calibration is the identity, and the
    statistic gather is skipped."""
    return base
