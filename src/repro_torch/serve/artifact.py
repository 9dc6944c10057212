"""KernelModelArtifact: the warm-boot factor store of the serving path (port
of ``repro.serve.artifact``).

After ``fast_model`` a replica has all it needs to answer queries without
touching the n × n kernel again: the landmark points X_S = X[P], the basis
C = K(X, X_S), the fast U, and small dense heads that turn one rectangular
cross launch G = K(X_query, X_S) into each answer:

- KRR prediction      f(x) = G @ head_krr,   head = U Cᵀ w        (c × t)
- KPCA projection     z(x) = G @ head_kpca,  head = U Cᵀ V Λ^-½   (c × k)
- Nyström features    φ(x) = G @ head_feat,  head = E_r Λ_U,r^½   (c × r)

all from the Nyström extension k̂(x, ·) = K(x, X_S) U Cᵀ.  The KRR weights
come from the Woodbury identity, and its (c × c) workspace
M = U (αI + CᵀC U)⁻¹ stays on the artifact, so new targets on the same
kernel are two thin products (``refit``), never another solve.

Persistence rides ``repro_torch.checkpoint`` in the reference's layout and
leaf names (``meta_json`` keeps the reference's keys, ``use_pallas``
included), so a store either package committed decodes in the other.
Damage is a ``CheckpointCorruptionError``, which ``load_or_rebuild`` turns
into a rebuild from source through ``ArtifactRecovery``.

Every tensor of an artifact lives on one device, the CUDA device unless the
caller names another (``device=``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.core import spsd
from repro_torch.core.eig import approx_eigh
from repro_torch.core.kernelop import PairwiseKernel
from repro_torch.device import resolve_device
from repro_torch.kernels.pairwise import signsplit
from repro_torch.kernels.pairwise import specs as pw_specs
from repro_torch.runtime.fault_tolerance import ArtifactRecovery

#: the query tasks the engine answers; head matrices are keyed by these
TASKS = ("krr", "kpca", "features")

_F32, _F64 = torch.float32, torch.float64


@dataclasses.dataclass
class KernelModelArtifact:
    """Everything ``serve_kernel_model`` needs.  Heads are c × out; only
    ``C`` keeps an n-sized factor, for target re-fits and appends."""

    X_landmarks: torch.Tensor           # (c, d) selected points X[P]
    C: torch.Tensor                     # (n, c) basis K(X, X_S)
    U: torch.Tensor                     # (c, c) fast-model U (symmetrized)
    heads: Dict[str, torch.Tensor]      # task -> (c, out_dim)
    woodbury_M: torch.Tensor            # (c, c) U (αI + CᵀC U)⁻¹
    kpca_eigvals: torch.Tensor          # (k,) spectrum of the KPCA head
    spec: pw_specs.KernelSpec
    alpha: float                        # KRR ridge
    selection: str = "uniform"          # policy that chose P
    landmark_indices: Optional[torch.Tensor] = None
    use_kernel: bool = True
    # sign-split plan of an l1dist spec over the landmark points, built once
    # at build time: l1_route 'mxu_signsplit' (l1_edges holds the table),
    # 'vpu_loop' (no plan fits), or None (other statistics, or a store from
    # before the field: the operator then builds its own)
    l1_edges: Optional[torch.Tensor] = None
    l1_route: Optional[str] = None

    @property
    def c(self) -> int:
        return int(self.X_landmarks.shape[0])

    @property
    def device(self) -> torch.device:
        return self.X_landmarks.device

    def landmark_operator(self, use_kernel: Optional[bool] = None,
                          precision: Optional[str] = None) -> PairwiseKernel:
        """The operator query launches run through: a ``PairwiseKernel``
        over the landmark points, so ``op.cross(X_query, heads)`` is
        K(X_query, X_S) @ head per head in one launch.  ``precision``
        overrides the spec's tile policy for the launches (``'bf16_f32acc'``
        serves an f32-built artifact with bf16 tiles)."""
        uk = self.use_kernel if use_kernel is None else use_kernel
        spec = self.spec
        if precision is not None:
            spec = spec.with_precision(precision)
        op = PairwiseKernel(self.X_landmarks, spec, uk, device=self.device)
        if self.l1_route is not None and spec.stat == "l1dist":
            # the persisted plan (or the persisted decision that none fits)
            # instead of a per-instance rebuild
            op._l1_edges_cache = \
                self.l1_edges if self.l1_route == "mxu_signsplit" else None
        return op

    def refit(self, y) -> "KernelModelArtifact":
        """New KRR targets on the same kernel through the cached Woodbury
        workspace: w = (y − C M Cᵀ y)/α, head = U Cᵀ w (f32, no solve).
        Returns a copy with ``heads['krr']`` replaced."""
        y2 = torch.as_tensor(y, dtype=_F32, device=self.device)
        y2 = y2[:, None] if y2.ndim == 1 else y2
        C32 = self.C.to(_F32)
        w = (y2 - C32 @ (self.woodbury_M @ (C32.T @ y2))) / self.alpha
        heads = dict(self.heads)
        heads["krr"] = self.U.to(_F32) @ (C32.T @ w)
        return dataclasses.replace(self, heads=heads)


def _meta(artifact: KernelModelArtifact) -> str:
    return json.dumps({
        "spec_name": artifact.spec.name,
        "spec_params": list(artifact.spec.params),
        "spec_precision": artifact.spec.precision,
        "alpha": float(artifact.alpha),
        "selection": artifact.selection,
        "use_pallas": bool(artifact.use_kernel),
        "l1_route": artifact.l1_route,
        "format": 1,
    })


def artifact_to_tree(artifact: KernelModelArtifact) -> dict:
    """The dict tree ``checkpoint.save`` persists (and
    ``checkpoint.restore_tree`` rebuilds without a skeleton)."""
    tree = {
        "X_landmarks": artifact.X_landmarks,
        "C": artifact.C,
        "U": artifact.U,
        "heads": dict(artifact.heads),
        "woodbury_M": artifact.woodbury_M,
        "kpca_eigvals": artifact.kpca_eigvals,
        "meta_json": _meta(artifact),
    }
    if artifact.landmark_indices is not None:
        tree["landmark_indices"] = artifact.landmark_indices
    if artifact.l1_edges is not None:
        tree["l1_edges"] = artifact.l1_edges
    return tree


def tensor_on(x, device, dtype=None) -> torch.Tensor:
    """A restored leaf (numpy or tensor) as a tensor on ``device``; f32
    values and ints are carried bit for bit."""
    t = torch.as_tensor(np.array(x) if not isinstance(x, torch.Tensor)
                        else x, device=device)
    return t if dtype is None else t.to(dtype)


def artifact_from_tree(tree: dict, device=None) -> KernelModelArtifact:
    """Decode a tree (the port's or the reference's) onto ``device``."""
    device = resolve_device(device)
    meta = json.loads(str(np.asarray(tree["meta_json"]).item()))
    spec = pw_specs.get_spec(meta["spec_name"],
                             **{k: v for k, v in meta["spec_params"]})
    # precision is a spec field, not a factory parameter: stores from before
    # the field restore as f32
    spec = spec.with_precision(meta.get("spec_precision", "f32"))
    idx = tree.get("landmark_indices")
    edges = tree.get("l1_edges")
    return KernelModelArtifact(
        X_landmarks=tensor_on(tree["X_landmarks"], device),
        C=tensor_on(tree["C"], device),
        U=tensor_on(tree["U"], device),
        heads={k: tensor_on(v, device) for k, v in tree["heads"].items()},
        woodbury_M=tensor_on(tree["woodbury_M"], device),
        kpca_eigvals=tensor_on(tree["kpca_eigvals"], device),
        spec=spec,
        alpha=float(meta["alpha"]),
        selection=meta["selection"],
        landmark_indices=None if idx is None
        else tensor_on(idx, device, torch.int64),
        use_kernel=bool(meta["use_pallas"]),
        l1_edges=None if edges is None else tensor_on(edges, device),
        l1_route=meta.get("l1_route"),
    )


# ---------------------------------------------------------------------------
# build (training side)
# ---------------------------------------------------------------------------

def build_artifact(
    X,
    y,
    spec: pw_specs.KernelSpec,
    c: int,
    s: int,
    *,
    alpha: float = 1.0,
    n_components: int = 8,
    n_features: Optional[int] = None,
    s_sketch: str = "gaussian",
    selection: str = "uniform",
    idx=None,
    S=None,
    generator: Optional[torch.Generator] = None,
    use_kernel: bool = True,
    block_size: Optional[int] = None,
    mesh=None,
    device=None,
) -> KernelModelArtifact:
    """Algorithm 1 and every head, once, at build time.

    Runs ``fast_model`` on ``PairwiseKernel(X, spec, use_kernel)`` — one
    fused launch gathers C and forms K S with a projection sketch — with
    the draws ``idx`` and ``S`` where given, else from ``generator``.
    Then, in f64 on the same device: the KRR weights by the Woodbury
    identity with its (c × c) workspace kept for ``refit``, the KPCA head
    from ``approx_eigh`` (Lemma 10) and the rank-``n_features`` Nyström
    feature head from the eigendecomposition of U; the heads are stored
    in f32.
    """
    a = float(alpha)
    if not (a > 0.0 and np.isfinite(a)):
        raise ValueError(f"alpha must be a finite positive ridge, got {a!r}")
    Kop = PairwiseKernel(X, spec, use_kernel, device=device)
    dev = Kop.device
    Xd = torch.as_tensor(X, dtype=_F32, device=dev)
    ap = spsd.fast_model(Kop, c, s, s_sketch=s_sketch, selection=selection,
                         block_size=block_size, mesh=mesh, idx=idx, S=S,
                         generator=generator)
    C32 = ap.C.to(_F32)
    U32 = (0.5 * (ap.U + ap.U.T)).to(_F32)

    # KRR: w from the Woodbury identity, in f64 so the f32 heads are
    # accurate to the true solution and the serving parity gate (≤ 1e-5
    # against the dense oracle) measures f32 rounding and the cross launch
    C64, U64 = C32.to(_F64), U32.to(_F64)
    eye = torch.eye(c, dtype=_F64, device=dev)
    inner = a * eye + (C64.T @ C64) @ U64
    M64 = U64 @ torch.linalg.solve(inner, eye)
    y64 = torch.as_tensor(y, device=dev).to(_F64)
    y64 = y64[:, None] if y64.ndim == 1 else y64
    w64 = (y64 - C64 @ (M64 @ (C64.T @ y64))) / a
    head_krr = (U64 @ (C64.T @ w64)).to(_F32)                  # (c, t)

    # KPCA: z(x) = Λ^-½ Vᵀ k̂(x,·)ᵀ = K(x, X_S) · U Cᵀ V Λ^-½
    eres = approx_eigh(C64, U64, n_components, dtype=_F64)
    lam = torch.clamp(eres.eigenvalues, min=1e-12)
    head_kpca = (U64 @ (C64.T @ eres.eigenvectors)
                 / torch.sqrt(lam)[None, :]).to(_F32)

    # Nyström features: U = E Λ_U Eᵀ ⇒ φ(x) = Λ_U,r^½ E_rᵀ K(x, X_S)ᵀ
    r = c if n_features is None else min(int(n_features), c)
    lam_u, E = torch.linalg.eigh(U64)                          # ascending
    lam_u = torch.clamp(torch.flip(lam_u, dims=(0,)), min=0.0)
    E = torch.flip(E, dims=(1,))
    head_feat = (E[:, :r] * torch.sqrt(lam_u[:r])[None, :]).to(_F32)

    X_land = Xd[ap.P_indices]
    l1_edges, l1_route = None, None
    if spec.stat == "l1dist":
        plan = signsplit.build_plan(X_land)
        l1_edges = None if plan is None else \
            torch.as_tensor(plan.edges, device=dev)
        l1_route = "vpu_loop" if plan is None else "mxu_signsplit"

    return KernelModelArtifact(
        X_landmarks=X_land, C=C32, U=U32,
        heads={"krr": head_krr, "kpca": head_kpca, "features": head_feat},
        woodbury_M=M64.to(_F32),
        kpca_eigvals=eres.eigenvalues.to(_F32),
        spec=spec, alpha=a, selection=str(selection),
        landmark_indices=ap.P_indices, use_kernel=bool(use_kernel),
        l1_edges=l1_edges, l1_route=l1_route)


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

def save_artifact(directory: str, artifact: KernelModelArtifact,
                  step: int = 0) -> str:
    """Atomically commit the artifact as checkpoint ``step``."""
    return ckpt.save(directory, step, artifact_to_tree(artifact))


def load_artifact(directory: str, step: Optional[int] = None,
                  device=None) -> Optional[KernelModelArtifact]:
    """Latest (or pinned) committed artifact on ``device``, or None when
    none exists.  Delta-chain aware: a target step that is an incremental
    refresh generation (a ``delta_json`` leaf) is replayed onto its base
    snapshot.  Damage and broken chains raise ``CheckpointCorruptionError``;
    callers that must keep serving use ``load_or_rebuild``."""
    if step is None:
        step = ckpt.latest_step(directory)
        if step is None:
            return None
    # the step's kind from the manifest alone: a delta tree has no
    # meta_json leaf and would read as corrupt
    if "delta_json" in ckpt.step_leaf_paths(directory, step):
        from repro_torch.serve import incremental
        return incremental.load_artifact_chain(directory, step,
                                               device=device)
    tree = ckpt.restore_tree(directory, step)
    try:
        return artifact_from_tree(tree, device=device)
    except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
        raise ckpt.CheckpointCorruptionError(
            f"artifact at {directory} step {step} does not decode "
            f"({type(e).__name__}: {e})") from e


def load_or_rebuild(
    directory: str,
    build_fn,
    recovery: Optional[ArtifactRecovery] = None,
    step: int = 0,
    device=None,
) -> Tuple[KernelModelArtifact, ArtifactRecovery]:
    """Warm boot with the recompute-on-corruption policy: ``build_fn()``
    runs only when the store is missing or damaged, and its artifact is
    persisted so the next replica boots warm.  Returns ``(artifact,
    recovery)``; ``recovery.warm`` tells a warm boot from a cold one."""
    if recovery is None:
        recovery = ArtifactRecovery(
            corruption_types=(ckpt.CheckpointCorruptionError,))
    out = recovery.run(
        load=lambda: load_artifact(directory, device=device),
        rebuild=build_fn,
        save=lambda a: save_artifact(directory, a, step=step))
    return out, recovery
