"""SPSD matrix approximation models (port of ``repro.core.spsd``).

All three models produce K ≈ C U Cᵀ with the same C = K P and differ in U:

- prototype:  U* = C† K (C†)ᵀ                    sees all of K
- Nyström:    U  = (Pᵀ K P)†                      sees n·c entries
- fast:       U  = (SᵀC)† (SᵀKS) (CᵀS)†          nc + (s−c)² entries

Every large-n path streams through the single-sweep panel engine:
``fast_model`` gathers C = K P and applies a projection sketch in ONE pass
over the kernel rows (one fused kernel launch), and
``fast_model_with_error`` adds the Hutchinson probes to the same pass.

Randomness: each randomized entry point takes a ``torch.Generator`` and also
the explicit draws — ``idx`` (the columns of C), ``S`` (a sketch object; an
(n, s) matrix for a Gaussian sketch; ``(indices, scales)`` for a column
sketch, before the P ⊂ S union), ``Z`` (Hutchinson probes), ``Omega``
(subspace-iteration start) — so tests can hand the reference's draws to both
sides.  Draws left to the generator are taken in the order idx, Z, S.

``mesh=`` (a ``DeviceMesh`` with a ``data`` dim, see
``repro_torch.distributed.sharding``) shards every sweep a model or metric
makes; every rank gets the same inputs and draws and returns the full
result.

``fast_model_batched`` runs Algorithm 1 over a batch of kernels of one
size, and ``fast_model_ragged`` over datasets of mixed sizes, grouped by
``bucket_by_size`` and zero-padded to their bucket's height.  Where the
reference vmaps one batched operator, the port loops over a sequence of
operators, one ``fast_model`` call (and on the card one fused launch) per
item, with explicit per-item draws.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import selection as selection_lib
from repro_torch.core import sketch as sk
from repro_torch.core import sweep as sweep_lib
from repro_torch.core.kernelop import DenseSPSD, SPSDOperator, as_operator
from repro_torch.core.leverage import pinv, row_leverage_scores
from repro_torch.device import generator_or_default

# Below this n the dense error metrics are cheap and exact; above it "auto"
# switches to the streaming estimator.
_DENSE_N_CUTOFF = 2048

_F32 = torch.float32


class SPSDApprox(NamedTuple):
    """K ≈ C U Cᵀ."""
    C: torch.Tensor                              # (n, c)
    U: torch.Tensor                              # (c, c)
    P_indices: Optional[torch.Tensor] = None     # columns of K forming C

    def dense(self) -> torch.Tensor:
        return self.C @ self.U @ self.C.T

    def matmat(self, V: torch.Tensor) -> torch.Tensor:
        return self.C @ (self.U @ (self.C.T @ V))


def _tensor(x, device, dtype=_F32) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device)


def _index(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def _projection_sketch(S, kind: str, n: int, s: int, generator, device):
    """A projection sketch: the given one (an (n, s) matrix is a Gaussian
    sketch), or a fresh draw of ``kind``."""
    if S is None:
        return sk.make_sketch(kind, n, s, generator=generator, device=device)
    if isinstance(S, (sk.GaussianSketch, sk.SRHTSketch, sk.CountSketch,
                      sk.MaskedSketch)):
        return S
    return sk.GaussianSketch(_tensor(S, device))


def _column_sketch(S, n: int, device) -> sk.ColumnSketch:
    if isinstance(S, sk.ColumnSketch):
        return S
    indices, scales = S
    return sk.ColumnSketch(_index(indices, device), _tensor(scales, device),
                           n)


# ---------------------------------------------------------------------------
# U matrices
# ---------------------------------------------------------------------------

def prototype_U(K, C: torch.Tensor, block_size: Optional[int] = None,
                mesh=None) -> torch.Tensor:
    """U* = C† K (C†)ᵀ (Eq. 4), with K (C†)ᵀ streamed through ``matmat``."""
    Kop = as_operator(K)
    Cp = pinv(C)                                          # (c, n)
    KCpT = Kop.matmat(Cp.T, block_size=block_size, mesh=mesh)   # (n, c)
    return Cp @ KCpT.to(Cp.dtype)


def nystrom_U(W: torch.Tensor) -> torch.Tensor:
    """U = W† with W = Pᵀ K P (Eq. 3)."""
    return pinv(0.5 * (W + W.T))


def fast_U(StC: torch.Tensor, StKS: torch.Tensor) -> torch.Tensor:
    """U = (SᵀC)† (SᵀKS) (CᵀS)† (Eq. 5); O(s²c), independent of n."""
    StCp = pinv(StC)                      # (c, s)
    return StCp @ StKS.to(StCp.dtype) @ StCp.T


# ---------------------------------------------------------------------------
# End-to-end models
# ---------------------------------------------------------------------------

def sample_C(Kop: SPSDOperator, c: int, idx=None,
             generator: Optional[torch.Generator] = None) -> SPSDApprox:
    """Uniformly sample c columns of K to form C."""
    if idx is None:
        idx = selection_lib.get_policy("uniform").select(
            Kop, c, generator=generator)
    idx = _index(idx, Kop.device)
    C = Kop.columns(idx)
    return SPSDApprox(C=C, U=torch.eye(c, dtype=C.dtype, device=C.device),
                      P_indices=idx)


def prototype_model(K, C: torch.Tensor, P_indices=None,
                    block_size: Optional[int] = None) -> SPSDApprox:
    Kop = as_operator(K)
    return SPSDApprox(C=C, U=prototype_U(Kop, C, block_size=block_size),
                      P_indices=P_indices)


def nystrom_model(K, c: int, idx=None,
                  generator: Optional[torch.Generator] = None) -> SPSDApprox:
    Kop = as_operator(K)
    if idx is None:
        idx = selection_lib.get_policy("uniform").select(
            Kop, c, generator=generator)
    idx = _index(idx, Kop.device)
    C = Kop.columns(idx)
    W = Kop.block(idx, idx)
    return SPSDApprox(C=C, U=nystrom_U(W), P_indices=idx)


def _column_sketch_for_C(Kop: SPSDOperator, C: torch.Tensor, s: int,
                         s_sketch: str, P_indices, enforce_subset: bool,
                         scale: bool, mask: Optional[torch.Tensor], S,
                         generator):
    """The uniform/leverage S (given, or drawn), its P ⊂ S union, and the
    SᵀKS block (s² entries, no sweep)."""
    n = Kop.n
    if S is not None:
        S = _column_sketch(S, n, Kop.device)
    elif s_sketch == "leverage":
        # zero padding rows of a masked C have leverage 0: never sampled
        S = sk.leverage_column_sketch(row_leverage_scores(C), s, scale=scale,
                                      generator=generator)
    else:
        S = sk.uniform_column_sketch(n, s, scale=scale, mask=mask,
                                     generator=generator, device=Kop.device)
    if enforce_subset and P_indices is not None:
        S = sk.subset_union_sketch(S, P_indices, n)         # Corollary 5
    StC = S.left(C)
    blk = Kop.block(S.indices, S.indices)
    StKS = blk * (S.scales[:, None] * S.scales[None, :])
    return S, StC, StKS


def fast_model_from_C(
    K,
    C: torch.Tensor,
    s: int,
    P_indices=None,
    s_sketch: str = "leverage",
    enforce_subset: bool = True,
    scale: bool = False,
    streaming: Optional[bool] = None,
    block_size: Optional[int] = None,
    n_valid=None,
    S=None,
    generator: Optional[torch.Generator] = None,
    mesh=None,
) -> SPSDApprox:
    """Algorithm 1 given a fixed C.

    ``s_sketch`` ∈ {uniform, leverage, gaussian, srht, countsketch}.  Column
    sketches read an s×s block of K; projection sketches form SᵀKS through
    one panel sweep unless ``streaming=False`` (default: streaming for every
    implicit operator, dense for a ``DenseSPSD``).  ``S`` passes the sketch
    explicitly; ``n_valid`` marks the true size of a padded operator.
    """
    Kop = as_operator(K)
    n = Kop.n
    g = generator_or_default(generator)
    mask = None if n_valid is None else \
        (torch.arange(n, device=Kop.device) < n_valid).to(_F32)
    if P_indices is not None:
        P_indices = _index(P_indices, Kop.device)

    if s_sketch in ("uniform", "leverage"):
        _, StC, StKS = _column_sketch_for_C(
            Kop, C, s, s_sketch, P_indices, enforce_subset, scale, mask, S, g)
    else:
        Sk = _projection_sketch(S, s_sketch, n, s, g, Kop.device)
        if mask is not None:
            Sk = sk.MaskedSketch(Sk, mask)
        StC = Sk.left(C)
        if streaming is None:
            streaming = not isinstance(Kop, DenseSPSD)
        if streaming:
            StKS = sk.sym_streaming(Sk, Kop, block_size=block_size,
                                    mesh=mesh)
        else:
            StKS = Sk.sym(Kop.full())
    return SPSDApprox(C=C, U=fast_U(StC, StKS), P_indices=P_indices)


def fast_model(
    K,
    c: int,
    s: int,
    s_sketch: str = "leverage",
    enforce_subset: bool = True,
    scale: bool = False,
    streaming: Optional[bool] = None,
    block_size: Optional[int] = None,
    n_valid=None,
    selection="uniform",
    idx=None,
    S=None,
    generator: Optional[torch.Generator] = None,
    mesh=None,
) -> SPSDApprox:
    """Algorithm 1 end to end: select C = K P, then the fast U.

    ``selection`` names a registered ``SelectionPolicy`` (or is one); ``idx``
    bypasses it with explicit columns.  With a projection ``s_sketch`` on a
    streaming operator, the C gather and K S ride the SAME sweep — one fused
    launch evaluates every kernel entry once for the whole model.
    """
    Kop = as_operator(K)
    n = Kop.n
    g = generator_or_default(generator)
    mask = None if n_valid is None else \
        (torch.arange(n, device=Kop.device) < n_valid).to(_F32)
    if idx is None:
        idx = selection_lib.get_policy(selection).select(
            Kop, c, generator=g, block_size=block_size, mesh=mesh, mask=mask)
    idx = _index(idx, Kop.device)

    if streaming is None:
        streaming = not isinstance(Kop, DenseSPSD)
    if s_sketch in ("uniform", "leverage") or not streaming:
        C = Kop.columns(idx)
        if mask is not None:
            C = C * mask[:, None]
        return fast_model_from_C(
            Kop, C, s, P_indices=idx, s_sketch=s_sketch,
            enforce_subset=enforce_subset, scale=scale, streaming=streaming,
            block_size=block_size, n_valid=n_valid, S=S, generator=g,
            mesh=mesh)

    # fused path: C = K P and K S from ONE sweep over the row panels
    Sk = _projection_sketch(S, s_sketch, n, s, g, Kop.device)
    if mask is not None:
        Sk = sk.MaskedSketch(Sk, mask)
    C, KS = Kop.sweep(
        [sweep_lib.ColumnGatherPlan(idx), sk.plan_for_sketch(Sk)],
        block_size=block_size, mesh=mesh)
    if mask is not None:
        C = C * mask[:, None]
    U = fast_U(Sk.left(C), Sk.left(KS))
    return SPSDApprox(C=C, U=U, P_indices=idx)


def fast_model_with_error(
    K,
    c: int,
    s: int,
    s_sketch: str = "gaussian",
    probes: int = 64,
    enforce_subset: bool = True,
    scale: bool = False,
    block_size: Optional[int] = None,
    selection="uniform",
    idx=None,
    S=None,
    Z=None,
    generator: Optional[torch.Generator] = None,
    mesh=None,
) -> Tuple[SPSDApprox, torch.Tensor]:
    """Algorithm 1 + its Hutchinson relative error in ONE panel sweep.

    K @ Z joins the sweep that gathers C and applies the projection sketch,
    so model plus evaluation read each kernel entry once.  ``Z`` (n ×
    probes) passes the probes explicitly.  Returns ``(approx, rel_err)``
    with the estimator of ``relative_error(method="hutchinson")``.
    """
    Kop = as_operator(K)
    n = Kop.n
    g = generator_or_default(generator)
    if idx is None:
        idx = selection_lib.get_policy(selection).select(
            Kop, c, generator=g, block_size=block_size, mesh=mesh)
    idx = _index(idx, Kop.device)
    Z = sk.rademacher(n, probes, generator=g, device=Kop.device) \
        if Z is None else _tensor(Z, Kop.device)

    if s_sketch in ("uniform", "leverage"):
        C, KZ = Kop.sweep(
            [sweep_lib.ColumnGatherPlan(idx), sweep_lib.MatmulPlan(Z)],
            block_size=block_size, mesh=mesh)
        _, StC, StKS = _column_sketch_for_C(
            Kop, C, s, s_sketch, idx, enforce_subset, scale, None, S, g)
    else:
        Sk = _projection_sketch(S, s_sketch, n, s, g, Kop.device)
        C, KS, KZ = Kop.sweep(
            [sweep_lib.ColumnGatherPlan(idx), sk.plan_for_sketch(Sk),
             sweep_lib.MatmulPlan(Z)],
            block_size=block_size, mesh=mesh)
        StC, StKS = Sk.left(C), Sk.left(KS)

    approx = SPSDApprox(C=C, U=fast_U(StC, StKS), P_indices=idx)
    RZ = KZ.to(_F32) - approx.matmat(Z).to(_F32)
    err = torch.sum(RZ * RZ) / torch.sum(KZ * KZ)
    return approx, err


def _per_item(draws, count: int, name: str) -> list:
    """One draw per item: ``draws`` as a list, or ``count`` Nones."""
    if draws is None:
        return [None] * count
    draws = list(draws)
    if len(draws) != count:
        raise ValueError(f"{name} has {len(draws)} entries for {count} "
                         f"items")
    return draws


def fast_model_batched(
    Ks,
    c: int,
    s: int,
    s_sketch: str = "leverage",
    enforce_subset: bool = True,
    scale: bool = False,
    streaming: Optional[bool] = None,
    block_size: Optional[int] = None,
    n_valid=None,
    selection="uniform",
    idx=None,
    S=None,
    generator: Optional[torch.Generator] = None,
) -> SPSDApprox:
    """Algorithm 1 over a batch of kernels of one size n.

    ``Ks`` is a sequence of operators (the port's form of the reference's
    batched operator pytree; each may be a ``CountingOperator``) or a
    (B, n, n) tensor, one ``DenseSPSD`` per slice.  Each item runs
    ``fast_model`` on its own, in order.  ``idx`` and ``S`` give per-item
    draws (a sequence of B entries, each as ``fast_model`` takes it);
    draws left to ``generator`` are taken item by item.  Returns an
    ``SPSDApprox`` whose fields are stacked along a leading batch axis.

    Ragged batches: zero-pad each kernel's data to the common n and pass
    ``n_valid`` (B true sizes).  Sampling is restricted to valid rows, C's
    padding rows are zeroed and projection sketches are row-masked
    (``sketch.MaskedSketch``), so SᵀKS never sees a padding entry.
    """
    if isinstance(Ks, torch.Tensor):
        ops = [DenseSPSD(K) for K in Ks]
    else:
        ops = [as_operator(K) for K in Ks]
    B = len(ops)
    if B == 0:
        raise ValueError("fast_model_batched needs at least one item")
    if len({op.n for op in ops}) != 1:
        raise ValueError(f"items of a batch share one n (got "
                         f"{sorted({op.n for op in ops})}); pad them, or "
                         f"use fast_model_ragged")
    nvs = _per_item(None if n_valid is None else
                    [int(v) for v in n_valid], B, "n_valid")
    idxs, Ss = _per_item(idx, B, "idx"), _per_item(S, B, "S")
    g = generator_or_default(generator)
    outs = [fast_model(op, c, s, s_sketch=s_sketch,
                       enforce_subset=enforce_subset, scale=scale,
                       streaming=streaming, block_size=block_size,
                       n_valid=nv, selection=selection, idx=i, S=Si,
                       generator=g)
            for op, nv, i, Si in zip(ops, nvs, idxs, Ss)]
    return SPSDApprox(C=torch.stack([o.C for o in outs]),
                      U=torch.stack([o.U for o in outs]),
                      P_indices=torch.stack([o.P_indices for o in outs]))


def bucket_by_size(sizes, waste: float = 0.25) -> List[List[int]]:
    """Greedy size-bucketing for ragged batches: index groups whose padded
    height stays within ``(1 + waste)×`` each member's true size.

    Items are visited in descending size order (ties in input order) and
    join the current bucket while its padded height (its largest member)
    costs them at most a ``waste`` fraction of padding rows; otherwise a
    new bucket opens.
    """
    order = sorted(range(len(sizes)), key=lambda i: -int(sizes[i]))
    buckets, cur, cap = [], [], 0
    for i in order:
        n_i = int(sizes[i])
        if cur and cap > n_i * (1.0 + waste):
            buckets.append(cur)
            cur = []
        if not cur:
            cap = n_i
        cur.append(i)
    if cur:
        buckets.append(cur)
    return buckets


def pad_rows(X, n_pad: int) -> torch.Tensor:
    """``X`` (n, d) as f32 with zero rows appended up to ``n_pad``."""
    X = torch.as_tensor(X, dtype=_F32)
    pad = torch.zeros((n_pad - X.shape[0], X.shape[1]), dtype=_F32,
                      device=X.device)
    return torch.cat([X, pad], dim=0)


def fast_model_ragged(
    Xs: Sequence,
    make_operator,
    c: int,
    s: int,
    waste: float = 0.25,
    idx=None,
    S=None,
    generator: Optional[torch.Generator] = None,
    **kwargs,
) -> List[SPSDApprox]:
    """Algorithm 1 over a ragged list of datasets with automatic bucketing.

    ``Xs`` is a list of (n_i, d) arrays; ``make_operator`` maps one item's
    data, zero-padded to its bucket's height, to its operator (e.g.
    ``lambda Xp: RBFKernel(Xp, sigma=1.5)``).  Items are grouped by
    ``bucket_by_size(sizes, waste)`` and each bucket runs one
    ``fast_model_batched`` call with the true sizes as ``n_valid``.
    ``idx`` and ``S`` are per-item draws in the order of ``Xs`` (a
    projection sketch at the item's padded height); draws left to
    ``generator`` are taken item by item in bucket order.  Extra
    ``kwargs`` (``s_sketch``, ``selection``, …) pass through.  Returns
    per-item ``SPSDApprox`` with C trimmed to each item's n, ordered like
    ``Xs``.
    """
    sizes = [int(X.shape[0]) for X in Xs]
    idxs, Ss = _per_item(idx, len(Xs), "idx"), _per_item(S, len(Xs), "S")
    g = generator_or_default(generator)
    out: List[Optional[SPSDApprox]] = [None] * len(Xs)
    for bucket in bucket_by_size(sizes, waste):
        n_pad = max(sizes[i] for i in bucket)
        bat = fast_model_batched(
            [make_operator(pad_rows(Xs[i], n_pad)) for i in bucket], c, s,
            n_valid=[sizes[i] for i in bucket],
            idx=None if idx is None else [idxs[i] for i in bucket],
            S=None if S is None else [Ss[i] for i in bucket],
            generator=g, **kwargs)
        for j, i in enumerate(bucket):
            out[i] = SPSDApprox(C=bat.C[j][: sizes[i]], U=bat.U[j],
                                P_indices=bat.P_indices[j])
    return out


# ---------------------------------------------------------------------------
# Error metrics (paper §6)
#   dense       exact, materializes K — small n only
#   blocked     exact, ||K − CUCᵀ||_F² accumulated over row panels
#   hutchinson  ||R||_F² ≈ mean_z ||R z||² over Rademacher probes
#   auto        dense below _DENSE_N_CUTOFF (or for DenseSPSD), else blocked
# ---------------------------------------------------------------------------

def _resolve_error_method(Kop: SPSDOperator, method: str) -> str:
    if method != "auto":
        return method
    if isinstance(Kop, DenseSPSD) or Kop.n <= _DENSE_N_CUTOFF:
        return "dense"
    return "blocked"


def _blocked_residual_fro2(Kop: SPSDOperator, approx: SPSDApprox,
                           block_size: Optional[int], mesh=None,
                           extra_plans=()):
    """(||K − CUCᵀ||_F², ||K||_F², extra results) in ONE panel sweep."""
    C32 = approx.C.to(_F32)
    M = approx.U.to(_F32) @ C32.T                          # (c, n)
    *extras, (num, den) = Kop.sweep(
        [*extra_plans, sweep_lib.ResidualFroPlan(C32, M)],
        block_size=block_size, mesh=mesh)
    return num, den, extras


def _hutchinson_residual_fro2(Kop: SPSDOperator, approx: SPSDApprox,
                              Z: torch.Tensor, block_size: Optional[int],
                              mesh=None, extra_plans=()):
    """Rademacher estimates of (||K − CUCᵀ||_F², ||K||_F²), plus any
    ``extra_plans`` fused into the same probe sweep."""
    probes = Z.shape[1]
    *extras, KZ = Kop.sweep([*extra_plans, sweep_lib.MatmulPlan(Z)],
                            block_size=block_size, mesh=mesh)
    KZ = KZ.to(_F32)
    RZ = KZ - approx.matmat(Z).to(_F32)
    return torch.sum(RZ * RZ) / probes, torch.sum(KZ * KZ) / probes, extras


def relative_error(K, approx: SPSDApprox, method: str = "auto",
                   block_size: Optional[int] = None, probes: int = 64,
                   Z=None, generator: Optional[torch.Generator] = None,
                   mesh=None) -> torch.Tensor:
    """||K − C U Cᵀ||_F² / ||K||_F² (Fig. 3/4 y-axis).  The streaming
    methods cost exactly one sweep (sharded over ``mesh``); ``Z`` passes
    Hutchinson probes."""
    Kop = as_operator(K)
    method = _resolve_error_method(Kop, method)
    if method == "dense":
        Kd = Kop.full().to(_F32)
        R = Kd - approx.dense().to(_F32)
        return torch.sum(R * R) / torch.sum(Kd * Kd)
    if method == "blocked":
        num, den, _ = _blocked_residual_fro2(Kop, approx, block_size, mesh)
        return num / den
    if method == "hutchinson":
        Z = sk.rademacher(Kop.n, probes, generator=generator,
                          device=Kop.device) if Z is None \
            else _tensor(Z, Kop.device)
        num, den, _ = _hutchinson_residual_fro2(Kop, approx, Z, block_size,
                                                mesh)
        return num / den
    raise ValueError(f"unknown error method {method!r}")


def _gaussian(n: int, q: int, generator, device) -> torch.Tensor:
    g = generator_or_default(generator)
    return torch.randn((n, q), generator=g, dtype=_F32,
                       device=g.device).to(device)


def _subspace_eigvals_from_Y(Kop: SPSDOperator, Y: torch.Tensor, k: int,
                             power_iters: int, block_size: Optional[int],
                             mesh=None):
    """Finish subspace iteration from Y = K Ω: ``power_iters`` power passes
    plus the Rayleigh quotient."""
    for _ in range(power_iters):
        Q, _ = torch.linalg.qr(Y)
        Y = Kop.matmat(Q, block_size=block_size, mesh=mesh)
    Q, _ = torch.linalg.qr(Y)
    B = Q.T @ Kop.matmat(Q, block_size=block_size, mesh=mesh)
    B = 0.5 * (B + B.T)
    lam = torch.flip(torch.linalg.eigvalsh(B), dims=(0,))
    return lam[:k]


def streaming_topk_eigvals(K, k: int, oversample: int = 8,
                           power_iters: int = 2,
                           block_size: Optional[int] = None, Omega=None,
                           generator: Optional[torch.Generator] = None,
                           mesh=None) -> torch.Tensor:
    """Top-k eigenvalues by randomized subspace iteration (2 + power_iters
    streamed passes, O(n·(k+p)) memory); ``Omega`` passes the start."""
    Kop = as_operator(K)
    q = min(Kop.n, k + oversample)
    Omega = _gaussian(Kop.n, q, generator, Kop.device) if Omega is None \
        else _tensor(Omega, Kop.device)
    Y = Kop.matmat(Omega, block_size=block_size, mesh=mesh)
    return _subspace_eigvals_from_Y(Kop, Y, k, power_iters, block_size, mesh)


def error_vs_best_rank_k(K, approx: SPSDApprox, k: int, method: str = "auto",
                         block_size: Optional[int] = None, probes: int = 64,
                         Omega=None, Z=None,
                         generator: Optional[torch.Generator] = None,
                         mesh=None) -> torch.Tensor:
    """||K − CUCᵀ||_F² / ||K − K_k||_F² (the 1+ε target of Thm 3).

    Streaming methods use ||K − K_k||_F² = ||K||_F² − Σ_{i≤k} λ_i² with the
    top spectrum from subspace iteration whose first product Y = K Ω rides
    the residual (or probe) sweep: (2 + power_iters) sweeps in all.
    """
    Kop = as_operator(K)
    method = _resolve_error_method(Kop, method)
    if method == "dense":
        Kd = Kop.full().to(_F32)
        evals = torch.linalg.eigvalsh(Kd)
        fro2 = torch.sum(evals ** 2)
        tail = torch.sum(torch.sort(evals ** 2).values[: Kd.shape[0] - k])
        tail = torch.maximum(tail, 1e-12 * fro2)
        R = Kd - approx.dense().to(_F32)
        return torch.sum(R * R) / tail
    n = Kop.n
    q = min(n, k + 8)                       # streaming_topk_eigvals defaults
    power_iters = 2
    g = generator_or_default(generator)
    Omega = _gaussian(n, q, g, Kop.device) if Omega is None \
        else _tensor(Omega, Kop.device)
    omega_plan = sweep_lib.MatmulPlan(Omega)
    if method == "blocked":
        num, fro2, (Y,) = _blocked_residual_fro2(
            Kop, approx, block_size, mesh, extra_plans=[omega_plan])
    elif method == "hutchinson":
        Z = sk.rademacher(n, probes, generator=g, device=Kop.device) \
            if Z is None else _tensor(Z, Kop.device)
        num, fro2, (Y,) = _hutchinson_residual_fro2(
            Kop, approx, Z, block_size, mesh, extra_plans=[omega_plan])
    else:
        raise ValueError(f"unknown error method {method!r}")
    lam = _subspace_eigvals_from_Y(Kop, Y, k, power_iters, block_size,
                                   mesh)
    tail = torch.maximum(fro2 - torch.sum(lam ** 2), 1e-12 * fro2)
    return num / tail
