"""KernelSpec: the port's pluggable kernel-operator registry (port of
``repro.kernels.pairwise.specs``).

A ``KernelSpec`` captures what varies between kernels so that one pair of
CUDA kernels (``repro_torch.kernels.pairwise.kernel``) serves all of them:

- ``stat``: the pairwise statistic of a tile — ``'sqdist'`` (‖x−y‖₂²),
  ``'dot'`` (xᵀy) or ``'l1dist'`` (‖x−y‖₁; the sign-split form of
  ``signsplit`` when the operator has a segment plan, else a loop over the
  feature axis);
- ``entry_fn``: the elementwise statistic → entry function, in torch (the
  plain versions run it);
- ``epilogue``: the same function as the CUDA kernels evaluate it — an id
  plus its float parameters.  Built-in specs carry one.  ``None`` marks a
  spec with only a Python ``entry_fn`` (a user registration): on CUDA
  tensors its entry function is lowered once to a generated CUDA epilogue
  (``lower.py``, the kernels' ``EPI_USER`` epilogue) compiled into a variant of the pairwise
  kernels at first use (``build.user_library``); an entry outside
  ``lower``'s ops raises there, naming the op.  On CPU tensors nothing is
  lowered: the plain versions call ``entry_fn``;
- ``precision``: ``'f32'`` or ``'bf16_f32acc'`` (operands quantized to bf16
  round-to-nearest-even, every contraction and combine accumulated in f32).

The port keeps its own registry; it never registers into the reference's.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.pairwise import signsplit

#: statistics the kernels know how to compute from point tiles
STAT_KINDS = ("sqdist", "dot", "l1dist")

#: tile-evaluation precision policies (operand dtype × accumulator dtype)
PRECISIONS = ("f32", "bf16_f32acc")

#: the statistics' ids in the CUDA kernels
STAT_IDS = {"dot": 0, "sqdist": 1, "l1dist": 2}

#: entry functions the CUDA kernels evaluate, by epilogue id (index)
EPILOGUE_KINDS = ("identity", "exp_neg", "matern32", "polynomial",
                  "exp_affine")


def tile_dtype(precision: str) -> torch.dtype:
    """Operand dtype of a precision policy (accumulators are always f32)."""
    if precision == "bf16_f32acc":
        return torch.bfloat16
    if precision == "f32":
        return torch.float32
    raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")


class Epilogue(NamedTuple):
    """``entry_fn`` in the form the CUDA kernels take.

    ``identity``: t; ``exp_neg``: exp(−a·t); ``matern32``:
    (1 + a·r)·exp(−a·r) with r = sqrt(max(t, 0)); ``polynomial``:
    (a·t + b)^degree by repeated multiplication; ``exp_affine``:
    exp(a·t − b), rounded after the product and after the difference (the
    softmax Gram of sketched attention, exp(t/√d − offset)).
    """

    kind: str
    a: float = 0.0
    b: float = 0.0
    degree: int = 0

    @property
    def id(self) -> int:
        return EPILOGUE_KINDS.index(self.kind)


def integer_pow(x: torch.Tensor, p: int) -> torch.Tensor:
    """x**p for an integer p ≥ 0 by binary exponentiation, in the order of
    multiplications the reference's integer power uses (and the CUDA
    epilogue repeats)."""
    acc = None
    while p > 0:
        if p & 1:
            acc = x if acc is None else acc * x
        p >>= 1
        if p > 0:
            x = x * x
    return torch.ones_like(x) if acc is None else acc


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One SPSD kernel family for the shared pairwise kernels.

    ``entry_fn`` maps the f32 statistic elementwise to kernel entries.
    ``params`` is a hashable ``((name, value), ...)`` tuple.  Specs compare
    by field identity, so build them through the registered (cached)
    factories.
    """

    name: str
    stat: str
    entry_fn: Callable[[torch.Tensor], torch.Tensor]
    params: Tuple[Tuple[str, float], ...] = ()
    precision: str = "f32"
    epilogue: Optional[Epilogue] = None

    def __post_init__(self):
        if self.stat not in STAT_KINDS:
            raise ValueError(
                f"KernelSpec {self.name!r}: unknown stat {self.stat!r}; "
                f"one of {STAT_KINDS}")
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"KernelSpec {self.name!r}: unknown precision "
                f"{self.precision!r}; one of {PRECISIONS}")
        if self.epilogue is not None and \
                self.epilogue.kind not in EPILOGUE_KINDS:
            raise ValueError(
                f"KernelSpec {self.name!r}: unknown epilogue "
                f"{self.epilogue.kind!r}; one of {EPILOGUE_KINDS} "
                f"(a spec with only an entry_fn leaves epilogue=None: the "
                f"CUDA path lowers it)")

    def param(self, name: str):
        return dict(self.params)[name]

    def with_precision(self, precision: str) -> "KernelSpec":
        """This spec under another precision policy (cached: one object per
        (spec, precision))."""
        return _with_precision(self, precision)

    def tile_dtype(self) -> torch.dtype:
        return tile_dtype(self.precision)

    def __repr__(self):
        ps = ", ".join(f"{k}={v}" for k, v in self.params)
        prec = "" if self.precision == "f32" else f", {self.precision}"
        return f"KernelSpec({self.name}({ps}), stat={self.stat}{prec})"


_PRECISION_VARIANTS: dict = {}


def _with_precision(spec: KernelSpec, precision: str) -> KernelSpec:
    if precision == spec.precision:
        return spec
    key = (spec, precision)
    hit = _PRECISION_VARIANTS.get(key)
    if hit is None:
        hit = dataclasses.replace(spec, precision=precision)
        _PRECISION_VARIANTS[key] = hit
        _PRECISION_VARIANTS[(hit, spec.precision)] = spec
    return hit


# ---------------------------------------------------------------------------
# dense statistic + entry evaluation (the plain versions and diag)
# ---------------------------------------------------------------------------

def dot_f32acc(Xr: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """Xr @ Xc.T with an f32 accumulator whatever the operand dtype.

    bf16 values are exact in f32 and so are their pairwise products, so the
    f32 product of the upcast operands is the f32-accumulated contraction of
    the bf16 operands.
    """
    return Xr.to(torch.float32) @ Xc.to(torch.float32).T


def _sqdist(Xr: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """max(‖x‖² + ‖y‖² − 2 x·y, 0) with norms and combine in f32 on the
    (possibly quantized) operands."""
    Xr32 = Xr.to(torch.float32)
    Xc32 = Xc.to(torch.float32)
    xx = torch.sum(Xr32 * Xr32, dim=1)
    yy = torch.sum(Xc32 * Xc32, dim=1)
    cross = dot_f32acc(Xr, Xc)
    return torch.clamp(xx[:, None] + yy[None, :] - 2.0 * cross, min=0.0)


def _l1dist(Xr: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """Pairwise L1 distances accumulated one feature at a time (the
    plan-free route; the same order of sums as the CUDA kernels)."""
    Xr = Xr.to(torch.float32)
    Xc = Xc.to(torch.float32)
    acc = torch.zeros((Xr.shape[0], Xc.shape[0]), dtype=torch.float32,
                      device=Xr.device)
    for k in range(Xr.shape[1]):
        acc = acc + torch.abs(Xr[:, k:k + 1] - Xc[:, k][None, :])
    return acc


def stat_block(stat: str, Xr: torch.Tensor, Xc: torch.Tensor,
               precision: str = "f32",
               edges: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (|Xr| × |Xc|) pairwise statistic (f32 out).

    ``precision`` quantizes the point operands while every accumulator stays
    f32.  ``edges`` selects the sign-split form for ``l1dist``; other
    statistics ignore it.
    """
    dt = tile_dtype(precision)
    Xr = Xr.to(dt)
    Xc = Xc.to(dt)
    if stat == "dot":
        return dot_f32acc(Xr, Xc)
    if stat == "sqdist":
        return _sqdist(Xr, Xc)
    if stat == "l1dist":
        if edges is not None:
            return signsplit.l1dist(Xr, Xc, edges, dt)
        return _l1dist(Xr, Xc)
    raise ValueError(f"unknown stat {stat!r}")


def apply(spec: KernelSpec, Xr: torch.Tensor, Xc: torch.Tensor,
          edges: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K[ri, cj] = entry_fn(stat(x_ri, x_cj)) — the dense evaluation."""
    return spec.entry_fn(
        stat_block(spec.stat, Xr, Xc, spec.precision, edges))


def diag(spec: KernelSpec, X: torch.Tensor) -> torch.Tensor:
    """diag(K) in O(n·d): distance statistics vanish on the diagonal; the
    dot statistic is the row norms of the precision-quantized points."""
    X32 = X.to(spec.tile_dtype()).to(torch.float32)
    if spec.stat == "dot":
        t = torch.sum(X32 * X32, dim=1)
    else:
        t = torch.zeros((X.shape[0],), dtype=torch.float32, device=X.device)
    return spec.entry_fn(t)


def _identity(t):
    return t


@functools.lru_cache(maxsize=None)
def _stat_only(stat: str) -> KernelSpec:
    return KernelSpec(f"stat[{stat}]", stat, _identity,
                      epilogue=Epilogue("identity"))


def stat_only(spec) -> KernelSpec:
    """Identity-entry spec over ``spec``'s statistic (a spec or a stat
    name): the operator's entries are then the raw statistic."""
    return _stat_only(spec if isinstance(spec, str) else spec.stat)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., KernelSpec]] = {}


def register_kernel(name: str):
    """Decorator: register a ``KernelSpec`` factory under ``name``."""
    def deco(factory: Callable[..., KernelSpec]):
        _REGISTRY[name] = factory
        return factory
    return deco


def get_spec(name: str, **params) -> KernelSpec:
    """Build the named spec (default parameters unless overridden)."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown kernel {name!r}; registered: "
                         f"{registered_kernels()}")
    return _REGISTRY[name](**params)


def registered_kernels() -> Tuple[str, ...]:
    """Registered kernel names, sorted."""
    return tuple(sorted(_REGISTRY))


# parameterizations that keep entries O(1) on unit-scale data (the same
# table as the reference's)
_SUGGESTED_PARAMS = {
    "rbf": lambda d: dict(sigma=1.5),
    "laplacian": lambda d: dict(gamma=0.3),
    "matern32": lambda d: dict(length_scale=1.5),
    "polynomial": lambda d: dict(degree=3, gamma=1.0 / d, coef0=1.0),
    "linear": lambda d: {},
}


def suggested_params(name: str, d: int = 8) -> dict:
    """Test/benchmark parameters for ``name`` given feature dim ``d``."""
    fn = _SUGGESTED_PARAMS.get(name)
    return fn(d) if fn is not None else {}


def suggested_spec(name: str, d: int = 8) -> KernelSpec:
    """``get_spec`` with the suggested parameters."""
    return get_spec(name, **suggested_params(name, d))


# ---------------------------------------------------------------------------
# built-in specs (cached: one spec object per parameter set)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rbf(sigma: float) -> KernelSpec:
    gamma = 1.0 / (2.0 * sigma ** 2)
    return KernelSpec("rbf", "sqdist",
                      lambda sq: torch.exp(-gamma * sq),
                      params=(("sigma", sigma),),
                      epilogue=Epilogue("exp_neg", a=gamma))


@register_kernel("rbf")
def rbf(sigma: float = 1.0) -> KernelSpec:
    """K_ij = exp(−‖x_i − x_j‖² / (2σ²))."""
    return _rbf(float(sigma))


@functools.lru_cache(maxsize=None)
def _laplacian(gamma: float) -> KernelSpec:
    return KernelSpec("laplacian", "l1dist",
                      lambda t: torch.exp(-gamma * t),
                      params=(("gamma", gamma),),
                      epilogue=Epilogue("exp_neg", a=gamma))


@register_kernel("laplacian")
def laplacian(gamma: float = 1.0) -> KernelSpec:
    """K_ij = exp(−γ ‖x_i − x_j‖₁)."""
    return _laplacian(float(gamma))


@functools.lru_cache(maxsize=None)
def _matern32(length_scale: float) -> KernelSpec:
    a = 3.0 ** 0.5 / length_scale

    def entry(sq):
        r = torch.sqrt(torch.clamp(sq, min=0.0))
        return (1.0 + a * r) * torch.exp(-a * r)

    return KernelSpec("matern32", "sqdist", entry,
                      params=(("length_scale", length_scale),),
                      epilogue=Epilogue("matern32", a=a))


@register_kernel("matern32")
def matern32(length_scale: float = 1.0) -> KernelSpec:
    """Matérn-3/2: K_ij = (1 + √3 r/ℓ) exp(−√3 r/ℓ), r = ‖x_i − x_j‖₂."""
    return _matern32(float(length_scale))


@functools.lru_cache(maxsize=None)
def _polynomial(degree: int, gamma: Optional[float],
                coef0: float) -> KernelSpec:
    g = gamma if gamma is not None else 1.0

    def entry(t):
        return integer_pow(g * t + coef0, degree)

    return KernelSpec("polynomial", "dot", entry,
                      params=(("degree", degree), ("gamma", gamma),
                              ("coef0", coef0)),
                      epilogue=Epilogue("polynomial", a=g, b=coef0,
                                        degree=degree))


@register_kernel("polynomial")
def polynomial(degree: int = 3, gamma: Optional[float] = None,
               coef0: float = 1.0) -> KernelSpec:
    """K_ij = (γ xᵢᵀxⱼ + c)ᵖ — SPSD for integer p ≥ 1, γ > 0, c ≥ 0
    (``gamma=None`` means 1.0)."""
    degree = int(degree)
    if degree < 0:
        raise ValueError(f"polynomial degree must be ≥ 0 (got {degree})")
    return _polynomial(degree, None if gamma is None else float(gamma),
                       float(coef0))


@functools.lru_cache(maxsize=None)
def _linear() -> KernelSpec:
    return KernelSpec("linear", "dot", _identity,
                      epilogue=Epilogue("identity"))


@register_kernel("linear")
def linear() -> KernelSpec:
    """K = X Xᵀ — the identity entry function over the dot statistic."""
    return _linear()
