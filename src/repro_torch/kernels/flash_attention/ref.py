"""Plain PyTorch version of tiled attention: causal, GQA, sliding window
(port of ``repro.kernels.flash_attention.ref``).

    out = softmax(q kᵀ / √D + mask) v        per (batch, query head)

q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D/Dv) with Hq % Hkv == 0; query head h
reads kv head h // (Hq / Hkv).  Queries are right-aligned to the keys
(decode): query i sits at key position i + Sk − Sq.  ``window = w`` keeps
keys with 0 ≤ pos − col < w (with causality).  Every operand is widened to
f32; the output has q's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

_F32 = torch.float32


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              q_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``q_pos`` (Sq,) places each query at a key position; by default
    ``arange(Sq) + Sk − Sq``.  Passing positions computes a subset of the
    query rows of a longer call exactly as that call computes them."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    kr = torch.repeat_interleave(k, group, dim=1)
    vr = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(_F32), kr.to(_F32)) \
        / torch.sqrt(torch.tensor(float(D), dtype=_F32))
    if q_pos is None:
        q_pos = torch.arange(Sq, device=q.device) + (Sk - Sq)
    row = q_pos.to(q.device)[:, None]
    col = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= col <= row
    if window is not None:
        mask &= (row - col) < window
    s = torch.where(mask[None, None], s, float("-inf"))
    # a row that sees no key has an all −inf row and max −inf: it returns 0,
    # as the reference's kernel body does (m_safe, and max(l, 1e-30))
    m = torch.amax(s, dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(mask[None, None], torch.exp(s - m_safe),
                    torch.zeros((), dtype=_F32, device=q.device))
    p = p /torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr.to(_F32)).to(q.dtype)
