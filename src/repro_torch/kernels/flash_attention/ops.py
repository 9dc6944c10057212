"""Public entry point of flash attention (port of
``repro.kernels.flash_attention.ops``).

The device of q picks the route: the plain version on the CPU, a CUDA
kernel on the card (see ``kernel``: bf16 inputs run the tensor-core kernel,
f32 inputs the CUDA-core one), which raises on what it does not take.
Nothing is padded to the TPU's 128-row tiles and there are no block-size
knobs: the kernels mask their own ragged edges.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel as _k


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention over q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D/Dv) with GQA ->
    (B, Hq, Sq, Dv) in q's dtype.  Decode (Sq < Sk) right-aligns queries to
    keys; ``window`` is a sliding window in key positions behind the
    query."""
    if q.device.type == "cpu":
        return _k.flash_attention_plain(q, k, v, causal=causal, window=window)
    return _k.flash_attention_cuda(q, k, v, causal=causal, window=window)
