"""Incremental artifact maintenance: absorb appended rows in O(b·c) (port of
``repro.serve.incremental``).

A served corpus grows; a full ``build_artifact`` to absorb a b-row batch is
the cost the fast model exists to avoid.  This module keeps a live
``KernelModelArtifact`` under appends with one thin rectangular launch per
batch and small-matrix algebra everywhere else:

- **Extend C and the Gram statistics**: the new rows' only kernel access
  is G = K(X_new, X_S), a (b × c) block from ``cross``'s launch shape with
  the identity as right-hand side (``append_cross`` on a
  ``CountingOperator`` meters it as ``append_sweeps``).  C grows by
  stacking; the cached f64 statistics by rank-b updates: CᵀC += GᵀG,
  Cᵀy += Gᵀy_new.
- **Refresh fast U**: a damped landmark-residual update
  U' = U + η·sym(G⁺ (G − G U W) W⁺), η = b/(n+b), rank ≤ 2b, zero when the
  model already explains the new rows.  W = K(X_S, X_S) and W⁺ are computed
  once at state init (the landmarks never change).
- **Refresh the Woodbury workspace by a low-rank update**: the inner matrix
  moves by CᵀC·ΔU + GᵀG·U', an exactly factored rank ≤ 3b perturbation, so
  its inverse follows by the Woodbury identity with one (3b × 3b) solve,
  and the refreshed workspace matches the dense f64 oracle on the grown
  corpus to rounding.
- **Refresh every head from c × c statistics**: KRR from
  Cᵀw = (Cᵀy − CᵀC·M·Cᵀy)/α; KPCA via eigh(CᵀC) (the Lemma-10 basis
  without the n-sized C); features from eigh(U').
- **Checkpoint refresh generations as delta steps** layered on the base
  snapshot in the same store; ``load_chain`` replays a chain bit for bit,
  ``gc_superseded_deltas`` removes chains a newer full snapshot obsoleted,
  and damage anywhere in a chain is a ``CheckpointCorruptionError``.
- **Staleness**: the per-batch drift ‖G − G U W‖_F / ‖G‖_F and its running
  estimate are tracked per generation; past a threshold the maintainer
  re-sketches through ``ArtifactRecovery`` (event 'stale'), compacts the
  store and keeps serving.

The launch runs on the artifact's device; the f64 workspace is host numpy,
as in the reference (its matrices are c × c and b × c).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.device import resolve_device
from repro_torch.kernels.pairwise import specs as pw_specs
from repro_torch.runtime.fault_tolerance import (
    ArtifactRecovery,
    ArtifactStaleError,
)
from repro_torch.serve.artifact import (
    KernelModelArtifact,
    artifact_from_tree,
    artifact_to_tree,
    tensor_on,
)

_TINY = 1e-30
_F32, _F64 = torch.float32, torch.float64


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", _F64).numpy()


# ---------------------------------------------------------------------------
# state + policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IncrementalState:
    """The f64 host workspace ``append_rows`` updates in O(b·c²): the Gram
    statistics (CᵀC, Cᵀy), the inverse of the Woodbury inner matrix (kept by
    rank-b updates after the one solve at init), the landmark Gram
    W = K(X_S, X_S) and its pseudo-inverse, and the running error sums of
    the staleness signal."""

    CtC: np.ndarray                 # (c, c) f64  CᵀC of the live corpus
    Cty: np.ndarray                 # (c, t) f64  Cᵀy
    inner_inv: np.ndarray           # (c, c) f64  (αI + CᵀC U)⁻¹
    U64: np.ndarray                 # (c, c) f64  live fast U
    W: np.ndarray                   # (c, c) f64  K(X_S, X_S)
    W_pinv: np.ndarray              # (c, c) f64  W⁺ (computed once)
    alpha: float
    n: int                          # live corpus size
    generation: int = 0             # refresh generation (0 = base build)
    res_sq: float = 0.0             # Σ‖G − G U W‖_F² over generations
    gram_sq: float = 0.0            # Σ‖G‖_F² over generations
    error_est: float = 0.0          # running relative-residual estimate

    @property
    def c(self) -> int:
        return int(self.CtC.shape[0])


@dataclasses.dataclass(frozen=True)
class StalenessPolicy:
    """When landmark reuse stops being safe.

    - ``drift_threshold``: a batch whose relative residual
      ‖G − G U W‖_F / ‖G‖_F exceeds this triggers a re-sketch;
    - ``error_budget``: so does a running estimate above this;
    - ``max_generations``: a hard cap on the delta chain's length
      (0 = unlimited), which bounds a warm boot's replay.
    """

    drift_threshold: float = 0.5
    error_budget: float = 0.5
    max_generations: int = 0

    def should_resketch(self, stats: "GenerationStats") -> Optional[str]:
        """A readable reason to re-sketch, or None to keep going."""
        if stats.drift > self.drift_threshold:
            return (f"batch drift {stats.drift:.4f} > "
                    f"threshold {self.drift_threshold}")
        if stats.error_est > self.error_budget:
            return (f"streaming error estimate {stats.error_est:.4f} > "
                    f"budget {self.error_budget}")
        if 0 < self.max_generations <= stats.generation:
            return (f"generation {stats.generation} reached "
                    f"max_generations {self.max_generations}")
        return None


@dataclasses.dataclass(frozen=True)
class GenerationStats:
    """What one ``append_rows`` did: the staleness policy's input."""

    generation: int
    n_before: int
    batch_rows: int
    n_after: int
    drift: float                    # ‖G − G U W‖_F / ‖G‖_F of this batch
    error_est: float                # running estimate
    resketch: bool = False
    resketch_reason: str = ""


def landmark_gram(artifact: KernelModelArtifact) -> np.ndarray:
    """W = K(X_S, X_S) in f64: c² entries through the plain spec apply,
    once per state init."""
    return _host(pw_specs.apply(artifact.spec, artifact.X_landmarks,
                                artifact.X_landmarks))


def init_state(artifact: KernelModelArtifact, y) -> IncrementalState:
    """The f64 workspace of a (built or warm-booted) artifact and its
    training targets: the one from-scratch c × c solve; every refresh after
    it is a rank-b update."""
    a = float(artifact.alpha)
    C64 = artifact.C.to(_F64)
    y64 = torch.as_tensor(y, device=artifact.device).to(_F64)
    if y64.ndim == 1:
        y64 = y64[:, None]
    if y64.shape[0] != C64.shape[0]:
        raise ValueError(f"y has {y64.shape[0]} rows for an n="
                         f"{C64.shape[0]} artifact")
    CtC = _host(C64.T @ C64)
    Cty = _host(C64.T @ y64)
    U64 = _host(artifact.U)
    c = CtC.shape[0]
    inner_inv = np.linalg.solve(a * np.eye(c) + CtC @ U64, np.eye(c))
    W = landmark_gram(artifact)
    return IncrementalState(
        CtC=CtC, Cty=Cty, inner_inv=inner_inv, U64=U64,
        W=W, W_pinv=np.linalg.pinv(W), alpha=a, n=int(C64.shape[0]))


# ---------------------------------------------------------------------------
# the append-row refresh
# ---------------------------------------------------------------------------

def _sym(A: np.ndarray) -> np.ndarray:
    return 0.5 * (A + A.T)


def _refresh_heads(state: IncrementalState, artifact: KernelModelArtifact,
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Every head from c × c statistics (n never enters).

    KRR: Cᵀw = (Cᵀy − CᵀC·M·Cᵀy)/α (``refit``'s identity, in f64),
    head = U·Cᵀw.  KPCA: with CᵀC = V Σ² Vᵀ, Q = C V Σ⁻¹ is orthonormal and
    C U Cᵀ = Q (Σ Vᵀ U V Σ) Qᵀ, so eigh of that c × c core gives the
    Lemma-10 spectrum, and the head U·CᵀVec/√Λ needs only CᵀC.  Features:
    eigh(U) as at build time.
    """
    a = state.alpha
    U64 = state.U64
    M64 = U64 @ state.inner_inv
    Ctw = (state.Cty - state.CtC @ (M64 @ state.Cty)) / a
    head_krr = U64 @ Ctw

    k = int(artifact.heads["kpca"].shape[1])
    sig2, V = np.linalg.eigh(state.CtC)                      # ascending
    sig2 = np.maximum(sig2, 0.0)
    cutoff = max(1, state.n) * np.finfo(np.float64).eps * \
        float(np.max(sig2, initial=0.0))
    sig = np.sqrt(np.maximum(sig2, _TINY))
    live = (sig2 > cutoff).astype(np.float64)
    VS = V * (sig * live)[None, :]                           # V Σ (dead→0)
    VSinv = V * (live / sig)[None, :]                        # V Σ⁻¹ (dead→0)
    Z = VS.T @ U64 @ VS
    lam, VZ = np.linalg.eigh(_sym(Z))                        # ascending
    order = np.argsort(lam)[::-1][:k]
    lam_k = np.maximum(lam[order], 1e-12)
    Vec_basis = VSinv @ VZ[:, order]                         # Cᵀ·Q V_Z = CᵀC·this
    head_kpca = U64 @ (state.CtC @ Vec_basis) / np.sqrt(lam_k)[None, :]

    r = int(artifact.heads["features"].shape[1])
    lam_u, E = np.linalg.eigh(_sym(U64))                     # ascending
    lam_u = np.maximum(lam_u[::-1], 0.0)
    E = E[:, ::-1]
    head_feat = E[:, :r] * np.sqrt(lam_u[:r])[None, :]

    dev = artifact.device
    heads = {"krr": _f32(head_krr, dev), "kpca": _f32(head_kpca, dev),
             "features": _f32(head_feat, dev)}
    return heads, _f32(lam_k, dev)


def _f32(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                           device=device)


def append_rows(
    artifact: KernelModelArtifact,
    state: IncrementalState,
    X_new,
    y_new,
    op=None,
    refresh_u: bool = True,
) -> Tuple[KernelModelArtifact, IncrementalState, GenerationStats,
           "DeltaRecord"]:
    """Absorb a b-row batch with one thin rectangular launch.

    ``op`` is the landmark operator the launch runs through (default
    ``artifact.landmark_operator()``); a ``CountingOperator`` meters it as
    one ``append_sweeps`` tick of b·c entries, and nothing else.  The rest
    is f64 host algebra on c × c and b × c matrices, with
    ``build_artifact``'s accuracy contract: the refreshed KRR head matches
    the dense f64 oracle on the grown corpus to f32 rounding.

    Returns ``(artifact', state', stats, delta)``; ``delta`` is the
    checkpointable record of the generation (``save_delta``).
    """
    if op is None:
        op = artifact.landmark_operator()
    X_new = torch.as_tensor(X_new, dtype=_F32, device=op.device)
    if X_new.ndim == 1:
        X_new = X_new[None, :]
    b = int(X_new.shape[0])
    c = state.c
    a = state.alpha

    # the one kernel access: G = K(X_new, X_S), a (b × c) launch
    launch = getattr(op, "append_cross", op.cross)
    (G,) = launch(X_new, (torch.eye(c, dtype=_F32, device=op.device),))
    G32 = G.to(_F32)
    G64 = _host(G32)

    y64 = _host(torch.as_tensor(y_new))    # host, device or array input
    if y64.ndim == 1:
        y64 = y64[:, None]
    if y64.shape[0] != b:
        raise ValueError(f"y_new has {y64.shape[0]} rows for a {b}-row batch")

    # drift: how badly the frozen landmark basis explains the new rows (on
    # the landmark block the model predicts K(x_new, X_S) ≈ G U W)
    R = G64 - G64 @ state.U64 @ state.W
    g_sq = float(np.sum(G64 * G64))
    r_sq = float(np.sum(R * R))
    drift = float(np.sqrt(r_sq / max(g_sq, _TINY)))

    # Gram statistics: exact rank-b updates
    CtC2 = state.CtC + G64.T @ G64
    Cty2 = state.Cty + G64.T @ y64

    # fast-U refresh: a damped symmetric landmark-residual correction,
    # factored as P_f @ Q_f with rank ≤ 2b (zero when R = 0)
    if refresh_u and b > 0:
        eta = b / max(state.n + b, 1)
        M1 = np.linalg.pinv(G64)                       # (c, b)
        M2 = R @ state.W_pinv                          # (b, c)
        P_f = np.concatenate([M1, M2.T], axis=1)       # (c, 2b)
        Q_f = 0.5 * eta * np.concatenate([M2, M1.T], axis=0)   # (2b, c)
        U2 = _sym(state.U64 + P_f @ Q_f)
    else:
        P_f = np.zeros((c, 0))
        Q_f = np.zeros((0, c))
        U2 = state.U64

    # the Woodbury workspace without a from-scratch c × c solve:
    # inner' − inner = CᵀC·ΔU + (GᵀG)·U' = P @ Q with rank ≤ 3b, so
    # inner'⁻¹ = inner⁻¹ − inner⁻¹P (I + Q inner⁻¹ P)⁻¹ Q inner⁻¹
    P = np.concatenate([state.CtC @ P_f, G64.T], axis=1)       # (c, ≤3b)
    Q = np.concatenate([Q_f, G64 @ U2], axis=0)                # (≤3b, c)
    IP = state.inner_inv @ P
    cap = np.eye(P.shape[1]) + Q @ IP
    inner_inv2 = state.inner_inv - IP @ np.linalg.solve(
        cap, Q @ state.inner_inv)

    res_sq = state.res_sq + r_sq
    gram_sq = state.gram_sq + g_sq
    error_est = float(np.sqrt(res_sq / max(gram_sq, _TINY)))
    state2 = IncrementalState(
        CtC=CtC2, Cty=Cty2, inner_inv=inner_inv2, U64=U2,
        W=state.W, W_pinv=state.W_pinv, alpha=a, n=state.n + b,
        generation=state.generation + 1,
        res_sq=res_sq, gram_sq=gram_sq, error_est=error_est)

    heads, kpca_eigvals = _refresh_heads(state2, artifact)
    dev = artifact.device
    M32 = _f32(U2 @ inner_inv2, dev)
    G32 = G32.to(dev)
    artifact2 = dataclasses.replace(
        artifact, C=torch.cat([artifact.C, G32], dim=0),
        U=_f32(U2, dev), heads=heads, woodbury_M=M32,
        kpca_eigvals=kpca_eigvals)

    stats = GenerationStats(
        generation=state2.generation, n_before=state.n, batch_rows=b,
        n_after=state2.n, drift=drift, error_est=error_est)
    delta = DeltaRecord(
        generation=state2.generation, base_step=0, G=G32,
        y_new=_f32(y64, dev), U=artifact2.U, heads=dict(heads),
        woodbury_M=M32, kpca_eigvals=kpca_eigvals, n_after=state2.n,
        drift=drift, error_est=error_est,
        state={"CtC": CtC2, "Cty": Cty2, "inner_inv": inner_inv2, "U64": U2})
    return artifact2, state2, stats, delta


# ---------------------------------------------------------------------------
# delta checkpoints: refresh generations layered on the store
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeltaRecord:
    """One refresh generation: the appended block (G, y_new — O(b·c)), the
    refreshed small matrices (so a replay is the live artifact bit for bit,
    with no recomputation) and the f64 maintainer state (so a fresh process
    resumes appending without a solve)."""

    generation: int
    base_step: int
    G: torch.Tensor                       # (b, c) f32: the appended C rows
    y_new: torch.Tensor                   # (b, t) f32
    U: torch.Tensor
    heads: Dict[str, torch.Tensor]
    woodbury_M: torch.Tensor
    kpca_eigvals: torch.Tensor
    n_after: int
    drift: float
    error_est: float
    state: Dict[str, np.ndarray]          # f64 CtC/Cty/inner_inv/U64


def _delta_meta(delta: DeltaRecord) -> str:
    return json.dumps({
        "generation": int(delta.generation),
        "base_step": int(delta.base_step),
        "n_after": int(delta.n_after),
        "drift": float(delta.drift),
        "error_est": float(delta.error_est),
        "format": 1,
    })


def delta_to_tree(delta: DeltaRecord) -> dict:
    return {
        "delta_json": _delta_meta(delta),
        "G": delta.G,
        "y_new": delta.y_new,
        "U": delta.U,
        "heads": dict(delta.heads),
        "woodbury_M": delta.woodbury_M,
        "kpca_eigvals": delta.kpca_eigvals,
        "state": {k: np.asarray(v, np.float64)
                  for k, v in delta.state.items()},
    }


def delta_from_tree(tree: dict, device=None) -> DeltaRecord:
    device = resolve_device(device)
    try:
        meta = json.loads(str(np.asarray(tree["delta_json"]).item()))
        return DeltaRecord(
            generation=int(meta["generation"]),
            base_step=int(meta["base_step"]),
            G=tensor_on(tree["G"], device),
            y_new=tensor_on(tree["y_new"], device),
            U=tensor_on(tree["U"], device),
            heads={k: tensor_on(v, device)
                   for k, v in tree["heads"].items()},
            woodbury_M=tensor_on(tree["woodbury_M"], device),
            kpca_eigvals=tensor_on(tree["kpca_eigvals"], device),
            n_after=int(meta["n_after"]),
            drift=float(meta["drift"]),
            error_est=float(meta["error_est"]),
            state={k: np.asarray(v, np.float64)
                   for k, v in tree["state"].items()})
    except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
        raise ckpt.CheckpointCorruptionError(
            f"delta step does not decode ({type(e).__name__}: {e})") from e


def is_delta_step(directory: str, step: int) -> bool:
    """A delta step carries a ``delta_json`` leaf, a full snapshot
    ``meta_json`` (read from the manifest alone)."""
    return "delta_json" in ckpt.step_leaf_paths(directory, step)


def save_delta(directory: str, step: int, delta: DeltaRecord) -> str:
    """Commit one refresh generation as checkpoint ``step``."""
    return ckpt.save(directory, step, delta_to_tree(delta))


def _apply_chain(base: KernelModelArtifact,
                 deltas: List[DeltaRecord]) -> KernelModelArtifact:
    """Replay a delta chain onto its base: concatenation and replacement of
    stored arrays, so the result is bit for bit the artifact that was live
    when the last delta committed."""
    if not deltas:
        return base
    C = torch.cat([base.C] + [d.G for d in deltas], dim=0)
    last = deltas[-1]
    return dataclasses.replace(
        base, C=C, U=last.U, heads=dict(last.heads),
        woodbury_M=last.woodbury_M, kpca_eigvals=last.kpca_eigvals)


def load_chain(directory: str, step: Optional[int] = None, device=None,
               ) -> Tuple[Optional[KernelModelArtifact], List[DeltaRecord]]:
    """The artifact at ``step`` (default: the latest committed), with its
    delta generations replayed onto their base snapshot.

    Every delta between the base and the target must be present, share the
    target's ``base_step`` and carry the generations 1..k; anything else (a
    removed middle link, a delta whose base was compacted away, damage in
    any step) is a ``CheckpointCorruptionError``.
    """
    steps = ckpt.committed_steps(directory)
    if step is None:
        if not steps:
            return None, []
        step = steps[-1]
    if not is_delta_step(directory, step):
        tree = ckpt.restore_tree(directory, step)
        return artifact_from_tree(tree, device=device), []

    target = delta_from_tree(ckpt.restore_tree(directory, step), device)
    base_step = target.base_step
    if base_step not in steps:
        raise ckpt.CheckpointCorruptionError(
            f"delta step {step} references base step {base_step}, which is "
            f"not committed in {directory}")
    if is_delta_step(directory, base_step):
        raise ckpt.CheckpointCorruptionError(
            f"delta step {step}'s base step {base_step} is itself a delta")
    base = artifact_from_tree(ckpt.restore_tree(directory, base_step),
                              device=device)

    chain: List[DeltaRecord] = []
    for s in steps:
        if base_step < s <= step and is_delta_step(directory, s):
            d = delta_from_tree(ckpt.restore_tree(directory, s), device)
            if d.base_step == base_step:
                chain.append(d)
    chain.sort(key=lambda d: d.generation)
    gens = [d.generation for d in chain]
    if gens != list(range(1, len(chain) + 1)) or \
            (chain and chain[-1].generation != target.generation):
        raise ckpt.CheckpointCorruptionError(
            f"broken delta chain in {directory}: generations {gens} "
            f"(target generation {target.generation}, base {base_step})")
    artifact = _apply_chain(base, chain)
    if int(artifact.C.shape[0]) != target.n_after:
        raise ckpt.CheckpointCorruptionError(
            f"delta chain replay produced n={int(artifact.C.shape[0])} but "
            f"generation {target.generation} recorded n_after="
            f"{target.n_after}")
    return artifact, chain


def load_artifact_chain(directory: str, step: Optional[int] = None,
                        device=None) -> Optional[KernelModelArtifact]:
    """Chain-aware restore (what ``serve.load_artifact`` delegates to when
    the target step is a delta)."""
    artifact, _ = load_chain(directory, step, device=device)
    return artifact


def gc_superseded_deltas(directory: str) -> int:
    """Remove the delta steps a newer full snapshot supersedes.

    A delta belongs to the chain of its ``base_step``; once a newer full
    snapshot (a compaction or re-sketch) is committed, every delta based on
    an older one is unreachable and is deleted.  Junk entries (stray files,
    tmp dirs, torn manifests) are skipped.  Returns the count removed.
    """
    steps = ckpt.committed_steps(directory)
    kinds = {}
    for s in steps:
        try:
            kinds[s] = "delta" if is_delta_step(directory, s) else "full"
        except ckpt.CheckpointCorruptionError:
            continue                      # torn manifest: leave it alone
    fulls = [s for s, k in kinds.items() if k == "full"]
    if not fulls:
        return 0
    latest_full = max(fulls)
    removed = 0
    for s, kind in kinds.items():
        if kind != "delta":
            continue
        try:
            d = delta_from_tree(ckpt.restore_tree(directory, s), "cpu")
            superseded = d.base_step < latest_full
        except ckpt.CheckpointCorruptionError:
            # an unreadable delta is dead weight once a full snapshot
            # follows it; only remove it when it is older
            superseded = s < latest_full
        if superseded:
            ckpt.remove_step(directory, s)
            removed += 1
    return removed


def compact(directory: str, artifact: KernelModelArtifact,
            step: Optional[int] = None) -> int:
    """Commit a full snapshot of the live artifact (default: one step past
    the latest committed) and remove the delta chain it supersedes.
    Returns the new base step."""
    if step is None:
        steps = ckpt.committed_steps(directory)
        step = (steps[-1] + 1) if steps else 0
    ckpt.save(directory, step, artifact_to_tree(artifact))
    gc_superseded_deltas(directory)
    return step


# ---------------------------------------------------------------------------
# the maintainer: appends, delta checkpoints, staleness-triggered re-sketch
# ---------------------------------------------------------------------------

class IncrementalMaintainer:
    """Owns a live artifact under appends: one thin launch per batch, a
    delta checkpoint per generation, and a staleness policy that escalates
    to a full re-sketch through ``ArtifactRecovery``.

    ``op`` (optional) is a long-lived wrapper for the thin launches (a
    ``CountingOperator`` meters ``append_sweeps``); it is ``rebind``-ed to
    the new landmark operator after a re-sketch.  ``rebuild_fn(X_full,
    y_full)`` recreates the artifact from the grown corpus, with its draws
    from a ``torch.Generator`` of its own; when it is given, ``X`` (the
    base training points) must be too.
    """

    def __init__(self, artifact: KernelModelArtifact, y, *,
                 directory: Optional[str] = None,
                 X=None,
                 staleness: Optional[StalenessPolicy] = None,
                 rebuild_fn=None,
                 recovery: Optional[ArtifactRecovery] = None,
                 op=None,
                 base_step: Optional[int] = None):
        self.artifact = artifact
        self.directory = directory
        self.staleness = staleness or StalenessPolicy()
        self.rebuild_fn = rebuild_fn
        self.recovery = recovery
        self.op = op
        self.state = init_state(artifact, y)
        y2 = _host_f32(y)
        self._y_parts: List[np.ndarray] = [
            y2 if y2.ndim == 2 else y2[:, None]]
        self._X_parts: List[np.ndarray] = \
            [] if X is None else [_host_f32(X)]
        if base_step is not None:
            self.base_step = base_step
        elif directory is not None:
            self.base_step = ckpt.latest_step(directory) or 0
        else:
            self.base_step = 0

    # -- grown-corpus views -------------------------------------------------

    def y_full(self) -> np.ndarray:
        return np.concatenate(self._y_parts, axis=0)

    def X_full(self) -> np.ndarray:
        if not self._X_parts:
            raise ValueError(
                "IncrementalMaintainer needs the base X to rebuild from the "
                "grown corpus; pass X= at construction when rebuild_fn is "
                "set")
        return np.concatenate(self._X_parts, axis=0)

    # -- the append path ----------------------------------------------------

    def append(self, X_new, y_new) -> GenerationStats:
        """Absorb one batch: one thin launch, a delta checkpoint, and the
        staleness check (which may replace the artifact by a re-sketch)."""
        artifact2, state2, stats, delta = append_rows(
            self.artifact, self.state, X_new, y_new, op=self.op)
        self.artifact, self.state = artifact2, state2
        Xb = _host_f32(X_new)
        yb = _host_f32(y_new)
        if Xb.ndim == 1:
            Xb = Xb[None, :]
        if self._X_parts:
            self._X_parts.append(Xb)
        self._y_parts.append(yb if yb.ndim == 2 else yb[:, None])
        if self.directory is not None:
            delta.base_step = self.base_step
            save_delta(self.directory, self.base_step + stats.generation,
                       delta)
        reason = self.staleness.should_resketch(stats)
        if reason is not None and self.rebuild_fn is not None:
            self._resketch(reason)
            stats = dataclasses.replace(stats, resketch=True,
                                        resketch_reason=reason)
        return stats

    def _resketch(self, reason: str):
        """A full rebuild on the grown corpus, routed through
        ``ArtifactRecovery`` so that it is a recorded 'stale' event; then
        compact the store and re-init the f64 workspace."""
        if self.recovery is None:
            self.recovery = ArtifactRecovery(
                corruption_types=(ckpt.CheckpointCorruptionError,),
                stale_types=(ArtifactStaleError,))

        gen = self.state.generation

        def load():
            raise ArtifactStaleError(
                f"refresh generation {gen}: {reason}")

        def save(art):
            if self.directory is not None:
                self.base_step = compact(self.directory, art)

        X_full, y_full = self.X_full(), self.y_full()
        artifact = self.recovery.run(
            load=load,
            rebuild=lambda: self.rebuild_fn(X_full, y_full),
            save=save)
        self.artifact = artifact
        self.state = init_state(artifact, y_full)
        if self.op is not None and hasattr(self.op, "rebind"):
            self.op.rebind(artifact.landmark_operator())


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", _F32).numpy()
    return np.asarray(x, np.float32)
