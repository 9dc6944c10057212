"""Public entry point of flash attention (port of
``repro.kernels.flash_attention.ops``).

The device of q picks the route: the plain version on the CPU, a CUDA
kernel on the card (see ``kernel``: bf16 inputs run the tensor-core kernel,
f32 inputs the CUDA-core one), which raises on what it does not take.
Nothing is padded to the TPU's 128-row tiles and there are no block-size
knobs: the kernels mask their own ragged edges.

Under grad mode, when q, k or v requires grad, the call goes through
``grad.FlashAttention``: the same forward route, and ``grad.attention_vjp``
as its backward.  Otherwise (serving, ``torch.no_grad()``) it is the plain
call above, with no autograd node.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import grad as _grad


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention over q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D/Dv) with GQA ->
    (B, Hq, Sq, Dv) in q's dtype.  Decode (Sq < Sk) right-aligns queries to
    keys; ``window`` is a sliding window in key positions behind the
    query."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _grad.FlashAttention.apply(q, k, v, causal, window)
    return _grad.route(q, k, v, causal, window)
