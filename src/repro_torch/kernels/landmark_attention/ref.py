"""Plain PyTorch version of the fused landmark-attention read (port of
``repro.kernels.landmark_attention.ref``).

Given the context-side factors of the paper's fast model (k_land (c, d),
UV = U(R̂V) (c, dv), U1 = U(R̂1) (c,)), the per-query read is

    cvec = exp(q @ k_landᵀ / sqrt(d) − offset)         (m, c)
    out  = (cvec @ UV) / sgnfloor(cvec @ U1, eps)       (m, dv)

where ``sgnfloor`` floors |den| at eps with the sign kept (an indefinite
fast U can push the normalizer negative; clamping to +eps would flip the
output row).  Every operand is widened to f32; the output has Q's dtype.
"""
from __future__ import annotations

import numpy as np
import torch

_F32 = torch.float32


def inv_sqrt_d(d: int) -> float:
    """1/sqrt(d) computed in f32, as the reference's oracle computes it
    (an f32 value, exact as a Python float)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def signed_floor(den: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """|den| floored at eps with den's sign; −0.0 gives +eps, NaN stays
    NaN."""
    return torch.where(den < 0.0, -1.0, 1.0) * torch.clamp(torch.abs(den),
                                                           min=eps)


def landmark_read(Q: torch.Tensor, k_land: torch.Tensor, UV: torch.Tensor,
                  U1: torch.Tensor, offset, eps: float = 1e-6
                  ) -> torch.Tensor:
    logits = (Q.to(_F32) @ k_land.to(_F32).T) * inv_sqrt_d(Q.shape[-1]) \
        - torch.as_tensor(offset, dtype=_F32, device=Q.device).reshape(())
    cvec = torch.exp(logits)
    num = cvec @ UV.to(_F32)
    den = cvec @ U1.to(_F32)
    return (num / signed_floor(den, eps)[:, None]).to(Q.dtype)
