"""Sign-split decomposition of the pairwise L1 statistic (port of
``repro.kernels.pairwise.signsplit``).

Per feature, the value range is cut into segments at midpoints between
consecutive distinct data values.  When x_k and y_k fall in different
segments the sign of (x_k − y_k) follows from the segment order, so

    ‖x − y‖₁ = α(x)·β(y) + β(x)·α(y)

with per-point embeddings over (feature × segment) slots

    α(u) = ⊕_s ( u·δ_s(u), −δ_s(u) ),   β(v) = ⊕_s ( L_s(v), v·L_s(v) ),

δ_s(u) = 1[segment(u) = s], L_s(v) = 1[segment(v) < s].  The identity is
exact whenever each segment holds at most one distinct value per feature,
which ``build_plan`` guarantees for the operator's own data.

``build_plan`` and ``query_in_plan`` are numpy-only copies of the
reference's host-side functions; ``embed`` and ``l1dist`` are the torch
counterparts of its jnp functions (two f32-accumulated contractions).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

#: default per-feature segment budget (embeddings are 2·d·B wide)
MAX_SEGMENTS = 32


@dataclasses.dataclass
class SignSplitPlan:
    """Per-feature segment edges: ``edges`` is (d, B−1) float32, ascending
    per row, padded with +inf (padded segments are empty)."""

    edges: np.ndarray

    @property
    def segments(self) -> int:
        return int(self.edges.shape[1]) + 1


def _host(X) -> np.ndarray:
    if isinstance(X, torch.Tensor):
        X = X.detach().cpu().numpy()
    return np.asarray(X, np.float32)


def build_plan(X, max_segments: int = MAX_SEGMENTS) -> Optional[SignSplitPlan]:
    """Sign-split edges derived from the data, or None when inapplicable.

    One host-side pass: per feature, the sorted distinct values and edges at
    consecutive midpoints.  None when any feature has more than
    ``max_segments`` distinct values, or X is not a finite 2-D array.
    """
    Xh = _host(X)
    if Xh.ndim != 2 or not np.all(np.isfinite(Xh)):
        return None
    d = Xh.shape[1]
    per_feature = []
    for k in range(d):
        u = np.unique(Xh[:, k])
        if u.shape[0] > max_segments:
            return None
        per_feature.append((u[:-1] + u[1:]) / 2.0)
    width = max(max(len(m) for m in per_feature), 1)
    edges = np.full((d, width), np.inf, np.float32)
    for k, m in enumerate(per_feature):
        edges[k, :len(m)] = m
    return SignSplitPlan(edges=edges)


def query_in_plan(X, Xq) -> bool:
    """True iff every query value equals some realized value of the same
    feature in ``X`` — the exactness contract of the sign-split form for
    out-of-sample points.  Non-finite queries are off-plan."""
    Xh = _host(X)
    Qh = _host(Xq)
    if Qh.ndim == 1:
        Qh = Qh[None, :]
    if Xh.ndim != 2 or Qh.ndim != 2 or Qh.shape[1] != Xh.shape[1]:
        return False
    if not np.all(np.isfinite(Qh)):
        return False
    return all(bool(np.isin(Qh[:, k], np.unique(Xh[:, k])).all())
               for k in range(Xh.shape[1]))


def embed(X: torch.Tensor, edges: torch.Tensor,
          compute_dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(α, β) sign-split embeddings, each (m, d·2B), from points (m, d).

    Segment indicators are exact 0/1 values computed in f32; the
    value-carrying slots are cast to ``compute_dtype`` so the bf16 policy
    quantizes the same numbers the reference quantizes.
    """
    m, d = X.shape
    X32 = X.to(torch.float32)
    edges = edges.to(device=X.device, dtype=torch.float32)
    ge = (X32[:, :, None] >= edges[None, :, :]).to(torch.float32)
    ones = torch.ones((m, d, 1), dtype=torch.float32, device=X.device)
    zeros = torch.zeros((m, d, 1), dtype=torch.float32, device=X.device)
    # delta_s = 1[x >= e_{s-1}]·1[x < e_s] with e_{-1} = −inf, e_{B-1} = +inf;
    # L_s = 1[segment(x) < s] = 1[x < e_{s-1}]
    delta = torch.cat([ones, ge], dim=2) * torch.cat([1.0 - ge, ones], dim=2)
    L = torch.cat([zeros, 1.0 - ge], dim=2)
    xv = X32[:, :, None]
    alpha = torch.cat([xv * delta, -delta], dim=2)
    beta = torch.cat([L, xv * L], dim=2)
    nseg = edges.shape[1] + 1
    alpha = alpha.reshape(m, d * 2 * nseg).to(compute_dtype)
    beta = beta.reshape(m, d * 2 * nseg).to(compute_dtype)
    return alpha, beta


def _dot_f32acc(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    # bf16 operands are exact in f32, so an f32 product of the upcast
    # operands is the f32-accumulated contraction of the bf16 values
    return A.to(torch.float32) @ B.to(torch.float32).T


def l1dist(Xr: torch.Tensor, Xc: torch.Tensor, edges: torch.Tensor,
           compute_dtype=torch.float32) -> torch.Tensor:
    """Pairwise ‖x−y‖₁ via the sign-split form (two contractions, f32
    accumulation; only the operands follow ``compute_dtype``)."""
    ar, br = embed(Xr, edges, compute_dtype)
    ac, bc = embed(Xc, edges, compute_dtype)
    out = _dot_f32acc(ar, bc) + _dot_f32acc(br, ac)
    return torch.clamp(out, min=0.0)
