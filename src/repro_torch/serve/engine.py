"""serve_kernel_model: batched query answering over a KernelModelArtifact
(port of ``repro.serve.engine``).

The query-time cost is one rectangular cross launch per bucket.  A
bucket's requests — any mix of KRR / KPCA / feature tasks and query counts
— are zero-padded to the bucket's height (``bucket_by_size`` bounds each
request's padding at ``waste``), stacked into one (rows × d) block, and
answered by a single ``op.cross(X_flat, heads)``: on the card one launch
of the fused pairwise kernel (B1), which builds each K(x_query, x_landmark)
tile once and contracts it against every head the bucket needs.  Each
request's answer is a slice of the launch's result; padding rows are
computed and dropped.

``op`` defaults to ``artifact.landmark_operator()`` and may be any wrapper
with the same ``cross`` contract (a ``CountingOperator`` meters one
``cross_sweeps`` tick per bucket).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.spsd import bucket_by_size, pad_rows
from repro_torch.kernels.pairwise import specs as pw_specs
from repro_torch.serve.artifact import TASKS, KernelModelArtifact

_F32, _F64 = torch.float32, torch.float64


@dataclasses.dataclass
class QueryRequest:
    """One request: ``task`` ∈ {'krr', 'kpca', 'features'} over the query
    points ``X`` (n_q × d, the training data's feature space)."""

    X: torch.Tensor
    task: str = "krr"

    def __post_init__(self):
        if self.task not in TASKS:
            raise ValueError(f"unknown task {self.task!r}; one of {TASKS}")
        self.X = torch.as_tensor(self.X, dtype=_F32)
        if self.X.ndim == 1:
            self.X = self.X[None, :]

    @property
    def n_q(self) -> int:
        return int(self.X.shape[0])


@dataclasses.dataclass
class QueryResult:
    """``out`` is (n_q × t) predictions, (n_q × k) projections or (n_q × r)
    features, by the request's task."""

    out: torch.Tensor
    task: str
    bucket: int                       # which launch answered it


def _as_request(q) -> QueryRequest:
    return q if isinstance(q, QueryRequest) else QueryRequest(X=q)


def answer_batch(artifact: KernelModelArtifact,
                 requests: Sequence[QueryRequest],
                 op=None, bucket: int = 0,
                 precision: Optional[str] = None) -> List[QueryResult]:
    """Answer one (already bucketed) batch with one cross launch.

    Requests are padded to the batch's largest height with zero points,
    stacked, and every head any request needs rides the same launch as
    another right-hand side.  ``precision`` (when ``op`` is not given)
    overrides the spec's tile policy for the launch.
    """
    requests = [_as_request(q) for q in requests]
    if not requests:
        return []
    if op is None:
        op = artifact.landmark_operator(precision=precision)
    tasks = tuple(t for t in TASKS if any(r.task == t for r in requests))
    heads = tuple(artifact.heads[t].to(_F32) for t in tasks)

    h = max(r.n_q for r in requests)
    flat = torch.cat([pad_rows(r.X.to(op.device), h) for r in requests])
    outs = op.cross(flat, heads)
    by_task: Dict[str, torch.Tensor] = dict(zip(tasks, outs))
    return [QueryResult(out=by_task[r.task][i * h: i * h + r.n_q],
                        task=r.task, bucket=bucket)
            for i, r in enumerate(requests)]


def plan_buckets(requests: Sequence[QueryRequest],
                 waste: float = 0.25) -> List[List[int]]:
    """Index groups per launch: ``bucket_by_size`` over the query counts."""
    return bucket_by_size([r.n_q for r in requests], waste=waste)


def serve_kernel_model(
    artifact: KernelModelArtifact,
    queries,
    waste: float = 0.25,
    op=None,
    precision: Optional[str] = None,
) -> List[QueryResult]:
    """Answer a heterogeneous batch: one cross launch per size bucket,
    results in input order.

    ``queries`` are ``QueryRequest``s (or raw (n_q × d) arrays, read as KRR
    requests).  ``precision`` (when ``op`` is not given) overrides the tile
    policy of every launch — the bf16_f32acc serving mode.  The
    continuous-batching server (``repro_torch.launch.serve_kernel``) calls
    ``plan_buckets`` and ``answer_batch`` itself, to meter each request.
    """
    requests = [_as_request(q) for q in queries]
    results: List[Optional[QueryResult]] = [None] * len(requests)
    if op is None:
        op = artifact.landmark_operator(precision=precision)
    for b, bucket in enumerate(plan_buckets(requests, waste)):
        answers = answer_batch(artifact, [requests[i] for i in bucket],
                               op=op, bucket=b)
        for i, res in zip(bucket, answers):
            results[i] = res
    return results


# ---------------------------------------------------------------------------
# dense oracles (parity targets of the tests and the served trace)
# ---------------------------------------------------------------------------

def _landmark_block(artifact: KernelModelArtifact, Xq) -> torch.Tensor:
    """G = K(Xq, X_S) through the plain spec apply (no kernel), in f64."""
    Xq = torch.as_tensor(Xq, dtype=_F32, device=artifact.device)
    return pw_specs.apply(artifact.spec, Xq, artifact.X_landmarks).to(_F64)


def dense_oracle(artifact: KernelModelArtifact, Xq,
                 task: str = "krr") -> torch.Tensor:
    """The reference answer without the kernel: G = K(Xq, X_S) from the
    plain spec apply, the head applied in f64, on the artifact's device.
    KRR also has the independent ``dense_krr_oracle``."""
    return _landmark_block(artifact, Xq) @ artifact.heads[task].to(_F64)


def dense_krr_head(artifact: KernelModelArtifact, y) -> torch.Tensor:
    """U Cᵀ w with w from a direct dense f64 solve of
    (C U Cᵀ + αI) w = y (no Woodbury identity, no artifact head), on the
    artifact's device: (c × t).  The n × n system is freed before return;
    at n = 50,000 it is 20 GB, and the solve's LU copy another 20 GB.  It
    depends only on (artifact, y): solve once, then extend to any number
    of queries with ``dense_krr_oracle(..., head=)``."""
    C = artifact.C.to(_F64)
    U = artifact.U.to(_F64)
    y2 = torch.as_tensor(y, device=artifact.device).to(_F64)
    y2 = y2[:, None] if y2.ndim == 1 else y2
    Khat = C @ U @ C.T
    Khat.diagonal().add_(artifact.alpha)
    w = torch.linalg.solve(Khat, y2)
    del Khat
    return U @ (C.T @ w)


def dense_krr_oracle(artifact: KernelModelArtifact, Xq, y=None, *,
                     head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """End-to-end dense KRR on the approximated kernel, extended with
    k̂(x, ·) = K(x, X_S) U Cᵀ: the serving path must match it to ≤ 1e-5,
    which checks the Woodbury identity, the head algebra, the cross launch
    and persistence in one number.  Pass ``y`` (solves, see
    ``dense_krr_head``) or the ``head`` it returned."""
    if (y is None) == (head is None):
        raise ValueError("dense_krr_oracle takes one of y and head")
    if head is None:
        head = dense_krr_head(artifact, y)
    return _landmark_block(artifact, Xq) @ head


def parity_gap(a, b) -> float:
    """max |a − b| / max(1, max |b|): the scale-normalized parity metric of
    every serving assertion (≤ 1e-5 in the smoke gates)."""
    a = _host64(a)
    b = _host64(b)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", _F64).numpy()
    return np.asarray(x, np.float64)
