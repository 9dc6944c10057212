"""Attention mixers: GQA / MQA / sliding window / MLA / landmark decode
(port of ``repro.models.attention``, without cross-attention, which comes
with the encoder-decoder: ROADMAP A11-rest.4).

Layouts are the reference's: activations (B, S, d_model), heads in
(B, S, H, D).  The reference's sharding constraints have no counterpart
here (the model-stack sharding rules are ROADMAP A10-rest).

``attn_impl``: the reference chooses between an XLA einsum path ("xla") and
the Pallas flash kernel ("pallas"); both compute the same function.  Here
both values name one path, ``kernels.flash_attention.ops.flash_attention``:
the CUDA kernel (B6) on the card, its plain PyTorch version on the CPU.  The
field is kept so configs carry over.  MLA's full attention goes through
the same call, with q and k of width qk_nope + qk_rope and v of v_head_dim.

Decode caches (one per layer):

- full / global : {"k": (B, Smax, KV, D), "v": ...}         (pos passed in)
- local         : ring buffer {"k": (B, W, KV, D), "v": ...}
- MLA           : {"ckv": (B, Smax, R), "krope": (B, Smax, Dr)} — the
                  latent cache; decode attends in the latent space
                  (``mla_absorb``) or materializes K and V from it
- landmark      : the paper's fast-model factors per head:
                  {"k_land": (B, KV, c, D), "uv": (B, KV, c, Dv),
                   "u1": (B, KV, c), "offset": (B, KV)}

``attention_decode`` writes the new token's k and v (or latents) into the
cache in place and returns the same dict (the reference returns an updated
copy, which its jitted serve loop donates).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sketched_attention import (build_landmark_state,
                                                 signed_den_floor)
from repro_torch.device import generator_or_default
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers as L
from repro_torch.models.layers import as_compute

_F32 = torch.float32
NEG = -1e30


def _is_mla(cfg: ModelConfig, kind: str) -> bool:
    return cfg.use_mla and kind in ("attn", "global")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   device=None) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def w(shape):
        return L.dense_init(generator, shape, cfg.pdtype, device=device)

    if cfg.use_mla:
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        return {
            "wq_a": w((d, cfg.q_lora_rank)),
            "q_norm": L.init_rmsnorm(cfg.q_lora_rank, cfg.pdtype, device),
            "wq_b": w((cfg.q_lora_rank, h, dn + dr)),
            "wkv_a": w((d, cfg.kv_lora_rank + dr)),
            "kv_norm": L.init_rmsnorm(cfg.kv_lora_rank, cfg.pdtype, device),
            "wkv_b": w((cfg.kv_lora_rank, h, dn + dv)),
            "wo": w((h, dv, d)),
        }
    p = {"wq": w((d, h, hd)), "wk": w((d, kv, hd)), "wv": w((d, kv, hd)),
         "wo": w((h, hd, d))}
    if cfg.qk_norm:
        p["q_norm"] = L.init_rmsnorm(hd, cfg.pdtype, device)
        p["k_norm"] = L.init_rmsnorm(hd, cfg.pdtype, device)
    return p


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

def _proj(x: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one matmul."""
    d, h, k = w.shape
    return (x @ as_compute(w, dt).reshape(d, h * k)).unflatten(-1, (h, k))


def _out_proj(out: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", out, w) as one matmul."""
    h, k, d = w.shape
    return out.flatten(-2) @ as_compute(w, dt).reshape(h * k, d)


def _q(params: dict, cfg: ModelConfig, x: torch.Tensor,
       positions: torch.Tensor, theta: float) -> torch.Tensor:
    q = _proj(x, params["wq"], cfg.cdtype)
    if cfg.qk_norm:
        q = L.rmsnorm(params["q_norm"], q, cfg.norm_eps)
    return L.apply_rope(q.transpose(1, 2), positions, theta).transpose(1, 2)


def _qkv(params: dict, cfg: ModelConfig, x: torch.Tensor,
         positions: torch.Tensor, theta: float):
    """q (B, S, H, D), k and v (B, S, KV, D), in the compute dtype."""
    dt = cfg.cdtype
    q = _q(params, cfg, x, positions, theta)
    k = _proj(x, params["wk"], dt)
    v = _proj(x, params["wv"], dt)
    if cfg.qk_norm:
        k = L.rmsnorm(params["k_norm"], k, cfg.norm_eps)
    k = L.apply_rope(k.transpose(1, 2), positions, theta).transpose(1, 2)
    return q.contiguous(), k.contiguous(), v


def _theta(cfg: ModelConfig, kind: str) -> float:
    return cfg.rope_theta_local if kind == "local" else cfg.rope_theta


def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    return cfg.window if kind == "local" else None


# ---------------------------------------------------------------------------
# full-sequence self-attention (train / prefill)
# ---------------------------------------------------------------------------

def attend_full(params: dict, cfg: ModelConfig, q: torch.Tensor,
                k: torch.Tensor, v: torch.Tensor, kind: str) -> torch.Tensor:
    """Causal attention of projected q, k, v (B, S, ·, D) and the output
    projection.  One flash-attention call: the kernel on the card (views in
    the (B, H, S, D) layout, no copies), the plain version on the CPU."""
    out = fa_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True,
                                 window=_window(cfg, kind))
    return _out_proj(out.transpose(1, 2), params["wo"], cfg.cdtype)


def attention_full(params: dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, kind: str = "attn"
                   ) -> torch.Tensor:
    if cfg.use_mla:
        return mla_attend_full(params, cfg,
                               *_mla_project(params, cfg, x, positions))
    q, k, v = _qkv(params, cfg, x, positions, _theta(cfg, kind))
    return attend_full(params, cfg, q, k, v, kind)


# ---------------------------------------------------------------------------
# MLA (deepseek): low-rank q and a latent kv cache
# ---------------------------------------------------------------------------

def _mla_project(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """-> q_nope (B, S, H, dn), q_rope (B, S, H, dr) rotated, the latent
    ckv (B, S, R) and the shared rope key k_rope (B, S, dr) rotated, all in
    the compute dtype."""
    dt = cfg.cdtype
    dn, R = cfg.qk_nope_dim, cfg.kv_lora_rank
    ql = L.rmsnorm(params["q_norm"], x @ as_compute(params["wq_a"], dt),
                   cfg.norm_eps)
    q = _proj(ql, params["wq_b"], dt)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = L.apply_rope(q_rope.transpose(1, 2), positions,
                          cfg.rope_theta).transpose(1, 2)
    kv_a = x @ as_compute(params["wkv_a"], dt)                 # (B,S,R+dr)
    ckv = L.rmsnorm(params["kv_norm"], kv_a[..., :R], cfg.norm_eps)
    k_rope = L.apply_rope(kv_a[..., R:], positions, cfg.rope_theta)
    return q_nope, q_rope, ckv, k_rope


def mla_attend_full(params: dict, cfg: ModelConfig, q_nope: torch.Tensor,
                    q_rope: torch.Tensor, ckv: torch.Tensor,
                    k_rope: torch.Tensor) -> torch.Tensor:
    """Causal MLA over the projected parts (``_mla_project``): K and V
    materialized from the latents, ``krope`` broadcast over the heads, one
    flash-attention call with q/k of width dn + dr and v of width dv (the
    softmax scale is 1/√(dn + dr), as the reference's), then the output
    projection."""
    dt = cfg.cdtype
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    B, S, H, _ = q_nope.shape
    kvb = _proj(ckv, params["wkv_b"], dt)                      # (B,S,H,dn+dv)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([kvb[..., :dn], k_rope[:, :, None].expand(B, S, H, dr)],
                   dim=-1)
    v = kvb[..., dn:]
    out = fa_ops.flash_attention(qf.transpose(1, 2), kf.transpose(1, 2),
                                 v.transpose(1, 2), causal=True)
    return _out_proj(out.transpose(1, 2), params["wo"], dt)


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
               device=None) -> dict:
    """Zero cache for one layer (prefill fills it)."""
    dt = cfg.cdtype
    kv, hd = cfg.n_kv_heads, cfg.head_dim

    def z(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if _is_mla(cfg, kind):
        return {"ckv": z((batch, max_len, cfg.kv_lora_rank)),
                "krope": z((batch, max_len, cfg.qk_rope_dim))}
    if kind == "local" and cfg.window is not None:
        w = min(cfg.window, max_len)
        return {"k": z((batch, w, kv, hd)), "v": z((batch, w, kv, hd))}
    if kind == "global" and cfg.use_landmark_decode:
        c = cfg.landmark_c
        return {"k_land": z((batch, kv, c, hd)), "uv": z((batch, kv, c, hd)),
                "u1": z((batch, kv, c), _F32),
                "offset": z((batch, kv), _F32)}
    return {"k": z((batch, max_len, kv, hd)), "v": z((batch, max_len, kv, hd))}


# ---------------------------------------------------------------------------
# decode steps
# ---------------------------------------------------------------------------

def _decode_read(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cfg: ModelConfig, kv_valid: torch.Tensor) -> torch.Tensor:
    """q (B, 1, H, D) against k/v (B, Sk, KV, D/Dv) -> (B, 1, H, Dv), the
    kv heads read once (never repeated); ``kv_valid`` (1 | B, Sk) masks
    keys."""
    B, _, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, KV, H // KV, D).to(_F32)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k.to(_F32)) / (D ** 0.5)
    logits = torch.where(kv_valid[:, None, None, :], logits, NEG)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v.to(_F32))
    return out.reshape(B, 1, H, v.shape[-1]).to(cfg.cdtype)


def attention_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache: dict, pos: int, kind: str = "attn"
                     ) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, d); ``pos`` the new token's position.  Returns (y, cache)
    with the cache updated in place."""
    pos = int(pos)
    if _is_mla(cfg, kind):
        return _mla_decode(params, cfg, x, cache, pos), cache
    if kind == "global" and cfg.use_landmark_decode and "k_land" in cache:
        return _landmark_decode(params, cfg, x, cache, pos), cache
    positions = torch.tensor([pos], device=x.device)
    q, k_new, v_new = _qkv(params, cfg, x, positions, _theta(cfg, kind))
    kc, vc = cache["k"], cache["v"]
    if kind == "local" and cfg.window is not None:
        W = kc.shape[1]
        slot = pos % W
        j = torch.arange(W, device=x.device)
        slot_pos = pos - torch.remainder(pos - j, W)
        valid = ((slot_pos >= 0) & (slot_pos <= pos))[None]   # (1, W)
    else:
        slot = pos
        valid = (torch.arange(kc.shape[1], device=x.device) <= pos)[None]
    kc[:, slot] = k_new[:, 0].to(kc.dtype)
    vc[:, slot] = v_new[:, 0].to(vc.dtype)
    out = _decode_read(q, kc, vc, cfg, valid)
    return _out_proj(out, params["wo"], cfg.cdtype), cache


def _mla_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                cache: dict, pos: int) -> torch.Tensor:
    """One MLA decode step; writes the token's latents into the cache.

    ``mla_absorb``: attend in the latent space — q_nope·W_kᵀ against ckv
    plus q_rope against krope, the softmax and the read of ckv in f32
    einsums, then W_v.  Otherwise K and V are materialized from the whole
    latent cache and read as a full-cache decode does (``_decode_read``).
    Both use the scale 1/√(dn + dr) and mask positions after ``pos``."""
    dt = cfg.cdtype
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    positions = torch.tensor([pos], device=x.device)
    q_nope, q_rope, ckv_new, krope_new = _mla_project(params, cfg, x,
                                                      positions)
    ckv, krope = cache["ckv"], cache["krope"]
    ckv[:, pos] = ckv_new[:, 0].to(ckv.dtype)
    krope[:, pos] = krope_new[:, 0].to(krope.dtype)
    wkv_b = as_compute(params["wkv_b"], dt)                    # (R,H,dn+dv)
    w_k, w_v = wkv_b[..., :dn], wkv_b[..., dn:]
    S = ckv.shape[1]
    valid = torch.arange(S, device=x.device) <= pos
    if cfg.mla_absorb:
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, w_k)
        s_lat = torch.einsum("bshr,btr->bhst", q_lat.to(_F32), ckv.to(_F32))
        s_rope = torch.einsum("bshk,btk->bhst", q_rope.to(_F32),
                              krope.to(_F32))
        logits = (s_lat + s_rope) / ((dn + dr) ** 0.5)
        logits = torch.where(valid[None, None, None, :], logits, NEG)
        w = torch.softmax(logits, dim=-1)                      # (B,H,1,S)
        o_lat = torch.einsum("bhst,btr->bshr", w, ckv.to(_F32))
        out = torch.einsum("bshr,rhk->bshk", o_lat, w_v.to(_F32))
    else:
        k_nope = torch.einsum("btr,rhk->bthk", ckv, w_k)
        v = torch.einsum("btr,rhk->bthk", ckv, w_v)
        kf = torch.cat([k_nope, krope[:, :, None].expand(
            k_nope.shape[:3] + (dr,))], dim=-1)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        out = _decode_read(qf, kf, v, cfg, valid[None])
    return _out_proj(out.to(dt), params["wo"], dt)


def _landmark_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache: dict, pos: int) -> torch.Tensor:
    """One-token read against the paper's fast-model factors, O(c·d), in
    plain einsums as the reference computes it.

    The new token is *not* folded into the landmark state: the state is a
    context summary built at prefill, as in the reference.
    """
    dt = cfg.cdtype
    positions = torch.tensor([pos], device=x.device)
    q = _q(params, cfg, x, positions, cfg.rope_theta)[:, 0]    # (B, H, D)
    KV = cfg.n_kv_heads
    B, H, D = q.shape
    qg = q.reshape(B, KV, H // KV, D).to(_F32)
    kl = cache["k_land"].to(_F32)                              # (B,KV,c,D)
    logits = torch.einsum("bkgd,bkcd->bkgc", qg, kl) / (D ** 0.5)
    cvec = torch.exp(logits - cache["offset"][:, :, None, None])
    num = torch.einsum("bkgc,bkcv->bkgv", cvec, cache["uv"].to(_F32))
    den = torch.einsum("bkgc,bkc->bkg", cvec, cache["u1"])
    out = num / signed_den_floor(den)[..., None]
    out = out.reshape(B, 1, H, out.shape[-1]).to(dt)
    return _out_proj(out, params["wo"], dt)


def build_landmark_cache(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                         draws: Optional[dict] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> dict:
    """Prefill-side landmark cache from the full K/V (B, S, KV, D): the
    paper's Algorithm 1 on the softmax Gram, per (batch row, kv head).

    ``draws`` = {"p_idx": (B, KV, c), "skx": (B, KV, s)} gives the landmark
    and column-sketch indices of every head; without them each head draws
    its own from ``generator``, in (batch row, kv head) order.  k and v stay
    in the compute dtype, as the reference passes them.
    """
    B, S, KV, _ = k.shape
    g = generator_or_default(generator)
    outs = {"k_land": [], "uv": [], "u1": [], "offset": []}
    for b in range(B):
        for h in range(KV):
            given = {} if draws is None else {
                name: draws[name][b][h] for name in ("p_idx", "skx")}
            st = build_landmark_state(
                k[b, :, h], v[b, :, h], cfg.landmark_c, cfg.landmark_theta,
                cfg.landmark_selection, generator=g, device=k.device,
                **given)
            for name, t in zip(outs, st):
                outs[name].append(t)
    return {name: torch.stack(ts).unflatten(0, (B, KV))
            for name, ts in outs.items()}
