"""Mixture-of-Experts FFN of the deepseek-v3 and qwen2-moe families (port
of ``repro.models.moe``, the gather path).

Dispatch is the reference's static-shape, sort-based gather (no dense
(T, E, C) one-hot):

  1. route: top-k softmax probabilities per token, in f32 (the router
     weight is never cast to the compute dtype);
  2. sort the T·k assignments by expert id with a *stable* sort, so the
     same assignments overflow on the CPU and the card;
  3. bound each expert to C = cf·(T·k)/E slots (the reference's integer
     arithmetic, rounded up to a multiple of 8); the overflow drops;
  4. gather the tokens into an (E, C, d) buffer, run every expert as one
     batched GEMM (``torch.bmm``), and combine each token's k outputs with
     its routing weights.

Serving fills one buffer in place and reuses it for the experts' outputs.
Under grad mode the dispatch is out of place (``index_copy`` into a new
buffer, the outputs gathered from a fresh tensor), so no tensor autograd
saved is written; the values are the same bits.

The combine is deterministic: the reference scatter-adds the weighted
outputs into (T, d) (``out.at[st].add``), which on the card would be an
atomic ``index_add_`` whose float order changes from run to run.  Here the
k values of each token are put back in routing order, (T, k, d), and summed
over k in that fixed order, so two calls give the same bits.

Shared experts (deepseek's 1, qwen's 4) are one dense MLP of width
n_shared · moe_d_ff, added unconditionally.  The reference's
``moe_impl="shard_map"`` (expert parallelism over a mesh) falls back to
this gather path on one device, and so does the port; the expert-parallel
variant is ROADMAP A10-rest.  No custom kernel: the reference computes the
expert GEMMs, the sort and the scatter as XLA ops outside any Pallas
kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import as_compute

_F32 = torch.float32


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             device=None) -> dict:
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff

    def w(shape, dtype=cfg.pdtype):
        return L.dense_init(generator, shape, dtype, device=device)

    p = {"router": w((d, E), _F32), "wi_gate": w((E, d, ff)),
         "wi_up": w((E, d, ff)), "wo": w((E, ff, d))}
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(generator, cfg,
                                 d_ff=cfg.n_shared_experts * ff,
                                 device=device)
    return p


def _route(params: dict, cfg: ModelConfig, xf: torch.Tensor):
    """xf: (T, d) -> top-k weights (T, k) f32, expert ids (T, k) int64, and
    the Switch-style load-balance aux E · Σ_e frac_e · mean_prob_e."""
    logits = xf.to(_F32) @ params["router"].to(_F32)          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort puts the lower expert id first at a tie, as
    # ``jax.lax.top_k`` does (``torch.topk`` does not)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :cfg.moe_top_k], idx[:, :cfg.moe_top_k]
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    E = cfg.n_experts
    hard = torch.zeros((xf.shape[0], E), dtype=_F32, device=xf.device)
    hard.scatter_(1, idx, 1.0)
    frac = torch.mean(hard, dim=0) / cfg.moe_top_k
    aux = E * torch.sum(frac * torch.mean(probs, dim=0))
    return w, idx, aux


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for T tokens: max(1, int(cf·(T·k)/E)) rounded up to
    a multiple of 8 (at decode, T = B and C = 8).  T·k is formed first, as
    in the reference: (cf·T)·k rounds differently, and ``int`` can then
    land on the other side of an integer (cf = 0.7, k = 6, E = 8, T = 1,800:
    944 against 945)."""
    C = max(1, int(cfg.capacity_factor * (T * cfg.moe_top_k)
                   / cfg.n_experts))
    return -(-C // 8) * 8


def _assign(cfg: ModelConfig, idx: torch.Tensor, C: int):
    """The dispatch plan of the T·k assignments, in routing order (token t's
    j-th choice is entry t·k + j): its token, its buffer slot (E·C for a
    dropped assignment) and whether it is kept."""
    E, k = cfg.n_experts, cfg.moe_top_k
    eids = idx.reshape(-1)
    Tk = eids.shape[0]
    ar = torch.arange(Tk, device=idx.device)
    se, order = torch.sort(eids, stable=True)
    first = torch.searchsorted(se, se, side="left")
    pos_in_e = ar - first
    keep_s = pos_in_e < C
    slot_s = torch.where(keep_s, se * C + pos_in_e,
                         torch.full_like(se, E * C))
    slot = torch.empty_like(slot_s)
    slot[order] = slot_s
    keep = torch.empty_like(keep_s)
    keep[order] = keep_s
    return ar // k, slot, keep


def _tracks_grad(params: dict, xf: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether autograd records the dispatch: grad mode is on and its input,
    its routing weights or an expert bank requires grad.  Only then must the
    dispatch leave every tensor autograd saved unwritten."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in (xf, w, params["wi_gate"], params["wi_up"],
                                  params["wo"]))


def _dispatch_compute(params: dict, cfg: ModelConfig, xf: torch.Tensor,
                      w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Sort-based capacity dispatch.  xf: (T, d) -> (T, d) in the compute
    dtype."""
    T, d = xf.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    dt = cfg.cdtype
    C = capacity(cfg, T)
    tok, slot, keep = _assign(cfg, idx, C)
    # every drop lands in row E·C, which no expert reads
    train = _tracks_grad(params, xf, w)
    if train:
        buf = torch.zeros((E * C + 1, d), dtype=dt,
                          device=xf.device).index_copy(0, slot,
                                                       xf[tok].to(dt))
    else:
        buf = torch.empty((E * C + 1, d), dtype=dt, device=xf.device)
        buf[:E * C] = 0
        buf[slot] = xf[tok].to(dt)
    eb = buf[:E * C].view(E, C, d)                             # (E, C, d)
    gate = F.silu(torch.bmm(eb, as_compute(params["wi_gate"], dt)))
    up = torch.bmm(eb, as_compute(params["wi_up"], dt))
    ob = torch.bmm(gate * up, as_compute(params["wo"], dt))   # (E, C, d)
    del eb, gate, up
    if train:
        buf = torch.cat([ob.view(E * C, d), ob.new_zeros((1, d))])
    else:                                  # serving reuses the buffer
        buf[:E * C] = ob.view(E * C, d)
        buf[E * C] = 0                     # a dropped assignment adds 0
    del ob
    wk = (w.reshape(-1) * keep.to(_F32)).to(dt)
    vals = (buf[slot] * wk[:, None]).view(T, k, d)
    out = vals[:, 0]
    for j in range(1, k):                  # a fixed order: bit-repeatable
        out = out + vals[:, j]
    return out


def moe_ffn(params: dict, cfg: ModelConfig,
            x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss scalar f32)."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    w, idx, aux = _route(params, cfg, xf)
    out = _dispatch_compute(params, cfg, xf, w, idx)
    if cfg.n_shared_experts:
        out = out + L.mlp(params["shared"], cfg, xf)
    return out.reshape(B, S, d), aux
