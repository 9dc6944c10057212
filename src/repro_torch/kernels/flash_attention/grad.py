"""The gradient of flash attention: an ``autograd.Function`` whose forward
is B6 (the CUDA kernel on the card, its plain version on the CPU) and whose
backward is ``attention_vjp``.

The reference has no backward kernel: it trains on the einsum attention
(``attn_impl="xla"``, ``repro.models.attention._sdpa``) and XLA
differentiates it outside any Pallas kernel.  So the backward here is a
PyTorch computation, not a port of a kernel: ``attention_vjp`` recomputes
the softmax P chunk by chunk over the query rows, all in f32, and forms

    dV = Pᵀ dO,   dP = dO Vᵀ,   dS = P ∘ (dP − rowsum(dO ∘ O)),
    dQ = dS K · scale,   dK = dSᵀ Q · scale

with the forward's masks: right-aligned queries (``offs = Sk − Sq``), the
causal mask and the sliding window.  A chunk reads only the keys its rows
can see, so the score panel stays (B, Hq, chunk, ≤ Sk) — the reference's
``_sdpa`` blocks its queries at ``cfg.chunk_q = 1024`` the same way.  GQA:
each query head's dK and dV land on its kv head (``h // (Hq / Hkv)``),
summed over the group; K and V are never repeated in memory.  A row that
sees no key has P = 0 (the forward's output is 0 there), so its dQ is 0
and it adds nothing to dK and dV.  The head widths may differ (MLA's
D = 192 / Dv = 128).  The gradients come back in the inputs' dtypes.

The backward's work runs inside the profiler range ``VJP_RANGE``, so a
profile can class it apart from the forward kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import kernel as _k

_F32 = torch.float32
#: query rows per recomputed score panel
CHUNK_Q = 1024
#: profiler range of ``attention_vjp``
VJP_RANGE = "flash_attention.vjp"


def _key_range(r0: int, r1: int, offs: int, Sk: int, causal: bool,
               window: Optional[int]) -> Tuple[int, int]:
    """[lo, hi): the keys that query rows [r0, r1) can see."""
    hi = min(Sk, r1 + offs) if causal else Sk
    lo = 0 if window is None else max(0, r0 + offs - window + 1)
    return lo, hi


def attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, dout: torch.Tensor, causal: bool = True,
                  window: Optional[int] = None, chunk_q: int = CHUNK_Q
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``out = attention(q, k, v)`` for the cotangent
    ``dout``: q (B, Hq, Sq, D), k (B, Hkv, Sk, D), v (B, Hkv, Sk, Dv), out
    and dout (B, Hq, Sq, Dv), any strides."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    offs = Sk - Sq
    scale = _k.softmax_scale(D)
    dev = q.device
    with torch.profiler.record_function(VJP_RANGE):
        dq = torch.zeros((B, Hkv, G, Sq, D), dtype=_F32, device=dev)
        dk = torch.zeros((B, Hkv, Sk, D), dtype=_F32, device=dev)
        dv = torch.zeros((B, Hkv, Sk, Dv), dtype=_F32, device=dev)
        qg = q.reshape(B, Hkv, G, Sq, D)
        og = out.reshape(B, Hkv, G, Sq, Dv)
        dog = dout.reshape(B, Hkv, G, Sq, Dv)
        for r0 in range(0, Sq, chunk_q):
            r1 = min(r0 + chunk_q, Sq)
            lo, hi = _key_range(r0, r1, offs, Sk, causal, window)
            if hi <= lo:
                continue                      # no row of the chunk sees a key
            c, L = r1 - r0, hi - lo
            qc = qg[:, :, :, r0:r1].to(_F32).reshape(B, Hkv, G * c, D)
            kc = k[:, :, lo:hi].to(_F32)
            vc = v[:, :, lo:hi].to(_F32)
            s = torch.matmul(qc, kc.transpose(-1, -2)).mul_(scale)
            s = s.view(B, Hkv, G, c, L)
            row = torch.arange(r0, r1, device=dev)[:, None] + offs
            col = torch.arange(lo, hi, device=dev)[None, :]
            mask = torch.ones((c, L), dtype=torch.bool, device=dev)
            if causal:
                mask &= col <= row
            if window is not None:
                mask &= (row - col) < window
            s = s.masked_fill_(~mask, float("-inf"))
            m = torch.amax(s, dim=-1, keepdim=True)
            m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
            p = torch.exp_(s.sub_(m)).masked_fill_(~mask, 0.0)
            del s, m
            p = p.div_(torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30))
            doc = dog[:, :, :, r0:r1].to(_F32)
            delta = torch.sum(doc * og[:, :, :, r0:r1].to(_F32), dim=-1,
                              keepdim=True)
            p2 = p.view(B, Hkv, G * c, L)
            doc2 = doc.reshape(B, Hkv, G * c, Dv)
            dv[:, :, lo:hi] += torch.matmul(p2.transpose(-1, -2), doc2)
            dp = torch.matmul(doc2, vc.transpose(-1, -2)).view(B, Hkv, G, c,
                                                                L)
            ds = p.mul_(dp.sub_(delta))        # P ∘ (dP − rowsum(dO ∘ O))
            del dp, p, p2
            ds2 = ds.view(B, Hkv, G * c, L)
            dq[:, :, :, r0:r1] = torch.matmul(ds2, kc).mul_(scale).view(
                B, Hkv, G, c, D)
            dk[:, :, lo:hi] += torch.matmul(ds2.transpose(-1, -2),
                                            qc).mul_(scale)
            del ds, ds2
        return (dq.view(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype))


def route(q, k, v, causal: bool = True, window: Optional[int] = None
          ) -> torch.Tensor:
    """B6 by the device of q, through the custom op
    ``repro_torch::flash_attention`` (``kernel.flash_attention_op``): the
    plain version on the CPU, the kernel on the card (which raises on what
    it does not take), the output's shape alone on ``meta``."""
    return _k.flash_attention_op(q, k, v, causal, window)


class FlashAttention(torch.autograd.Function):
    """B6 forward, ``attention_vjp`` backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out = route(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = attention_vjp(q, k, v, out, dout, ctx.causal,
                                   ctx.window)
        return dq, dk, dv, None, None
