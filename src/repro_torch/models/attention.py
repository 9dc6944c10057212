"""Attention mixers: GQA / MQA / sliding window / MLA / cross / landmark
decode (port of ``repro.models.attention``).

Layouts are the reference's: activations (B, S, d_model), heads in
(B, S, H, D).

On a mesh (``distributed.sharding.use_mesh``, params as ``MeshParams``)
``attention_full`` is tensor-parallel over ``model``: each rank projects
and attends its own q heads (``wq``/``wo`` split by heads), against its
own kv heads where ``wk``/``wv`` are split too, else against the kv heads
its q heads map to (``_kv_heads_of``); the output projection's partial
sums are all-reduced.  Where the heads do not divide ``model`` and the
positions do, with ``seq_parallel_attn`` (``_sp_active``, the reference's
rule), each rank takes its S/tp query rows instead, against K/V
all-gathered once a layer and cut at its last row: B6 right-aligns
queries to keys, so the keys ``[:(r+1)·S/tp]`` give rank r the causal
mask without a new kernel argument.  The reference's
``with_sharding_constraint`` points are these redistributions.

Serving on a mesh: ``attention_prefill`` takes the same paths and
returns this rank's cache shard under ``sharding.cache_shardings``: split
by batch and kv heads, or by sequence (the local rings by slots), where
K/V computed split by heads move to the sequence split in one all-to-all
(``collectives.heads_to_seq``).  A decode step of a sequence-split cache
(``attention_decode``) reads the rank's positions for every head and merges
the partial reads by log-sum-exp in a fixed rank order
(``collectives.lse_merge``); only the rank holding the token's position
(or ring slot) writes it.  The landmark factors are whole over
``model``: each rank builds its kv heads' and all-gathers them.

MLA on a mesh runs over heads (``_mla``): each rank holds its heads of
``wq_b``, ``wkv_b`` and ``wo`` and its part of ``wq_a``'s q_rank columns
(the low-rank query all-gathered before its norm); ``wkv_a`` is
replicated, so the latent is whole on every ``model`` rank and a prefill
keeps its slice of it under the cache specs with no exchange.  Where the
heads do not divide ``model`` and the positions do, under
``seq_parallel_attn`` (``_mla_sp``), each rank projects its S/tp rows and
the latent is all-gathered once a layer (not K and V), expanded through
``wkv_b`` up to the rank's last row.  At decode
the latent cache may be split by sequence: absorbed, every head's latent
query reads the rank's positions and the partial reads merge by
log-sum-exp; materialized, the slices are all-gathered first
(``_mla_decode``).

``attn_impl``: the reference chooses between an XLA einsum path ("xla") and
the Pallas flash kernel ("pallas"); both compute the same function.  Here
both values name one path, ``kernels.flash_attention.ops.flash_attention``:
the CUDA kernel (B6) on the card, its plain PyTorch version on the CPU.  The
field is kept so configs carry over.  MLA's full attention goes through
the same call, with q and k of width qk_nope + qk_rope and v of v_head_dim.
So do the encoder-decoder's bidirectional encoder self-attention
(``attend_full(..., causal=False)``) and its cross-attention
(``cross_attention``: the decoder's queries, no RoPE, against the encoder
K/V of ``encoder_kv``), which the reference computes with its einsum
``_sdpa``: both are one non-causal call.

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
from repro_torch.core import sketched_attention as SA
from repro_torch.core.sketched_attention import (build_landmark_state,
                                                 signed_den_floor)
from repro_torch.device import generator_or_default
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers as L
from repro_torch.models.layers import as_compute

_F32 = torch.float32
NEG = -1e30


def _is_mla(cfg: ModelConfig, kind: str) -> bool:
    return cfg.use_mla and kind in ("attn", "global")


def _sp_active(cfg: ModelConfig, S: int) -> bool:
    """Sequence-parallel attention: only when heads don't divide the TP axis
    (otherwise head sharding is strictly better) and positions do."""
    if not cfg.seq_parallel_attn or S <= 1:
        return False
    tp = shd.ambient_axis_size("model")
    return tp > 1 and cfg.n_heads % tp != 0 and S % tp == 0


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   device=None, cross: bool = False) -> dict:
    """A self-attention mixer's weights, or with ``cross`` a cross-
    attention's (always q, k, v, o projections, as the reference's)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def w(shape):
        return L.dense_init(generator, shape, cfg.pdtype, device=device)

    if cfg.use_mla and not cross:
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
                k: torch.Tensor, v: torch.Tensor, kind: str,
                causal: bool = True) -> torch.Tensor:
    """Attention of projected q (B, Sq, H, D) over k, v (B, Sk, KV, ·),
    causal or bidirectional, under the kind's window, and the output
    projection.  One flash-attention call: the kernel on the card (views in
    the (B, H, S, D) layout, no copies), the plain version on the CPU."""
    out = fa_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 window=_window(cfg, kind))
    return _out_proj(out.transpose(1, 2), params["wo"], cfg.cdtype)


def attention_full(params: dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, kind: str = "attn"
                   ) -> torch.Tensor:
    if cfg.use_mla:
        return _mla(params, cfg, x, positions)[0]
    if _sp_active(cfg, x.shape[1]):
        return _attention_sp(params, cfg, x, positions, kind)
    if shd.split(params, "wq", 1):
        return _attention_tp(params, cfg, x, positions, kind)
    q, k, v = _qkv(params, cfg, x, positions, _theta(cfg, kind))
    return attend_full(params, cfg, q, k, v, kind)


def _kv_heads_of(rank: int, h_loc: int, cfg: ModelConfig) -> list:
    """The kv heads (global ids) that this rank's ``h_loc`` q heads read,
    for a replicated ``wk``/``wv``: each kv head once when the local heads
    are whole groups of one size, else one per q head (MHA locally)."""
    group = cfg.n_heads // cfg.n_kv_heads
    kvs = [(rank * h_loc + j) // group for j in range(h_loc)]
    uniq = sorted(set(kvs))
    rep = h_loc // len(uniq)
    if [u for u in uniq for _ in range(rep)] == kvs:
        return uniq
    return kvs


def _attention_tp(params: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, kind: str, with_kv: bool = False,
                  causal: bool = True):
    """Heads split over ``model``: this rank's q heads (and kv heads), the
    partial output projection summed over the ranks.  ``with_kv`` also
    returns the rank's k and v (B, S, ·, D): its own kv heads where
    ``wk``/``wv`` are split, else every kv head.  ``causal=False``: the
    encoder's bidirectional attention."""
    p = shd.tp_local(params)
    x = C.copy_to(x, "model")
    q, k, v = _qkv(p, cfg, x, positions, _theta(cfg, kind))
    kr, vr = _rank_kv(params, cfg, q, k, v)
    y = C.reduce_from(attend_full(p, cfg, q, kr, vr, kind, causal), "model")
    return (y, k, v) if with_kv else y


def _rank_kv(params: dict, cfg: ModelConfig, q: torch.Tensor,
             k: torch.Tensor, v: torch.Tensor):
    """The kv heads this rank's q heads read: k and v as they are where
    they hold the rank's own (``wk`` split, or a cache split by heads),
    else the ones its q heads map to (``_kv_heads_of``)."""
    if k.shape[2] != cfg.n_kv_heads or not shd.split(params, "wq", 1):
        return k, v
    idx = _kv_heads_of(shd.axis_index("model"), q.shape[2], cfg)
    return k[:, :, idx].contiguous(), v[:, :, idx]


def _attention_sp(params: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, kind: str, with_kv: bool = False):
    """Sequence-parallel attention: this rank's S/tp query rows against
    K/V all-gathered over ``model`` and cut at its last row; the output
    rows all-gathered back.  The weights are whole on every rank.
    ``with_kv`` also returns the whole K and V (every head and position)."""
    r, tp = shd.axis_index("model"), shd.ambient_axis_size("model")
    p = shd.tp_local(params)
    rows = x.shape[1] // tp
    xs = shd.constrain(x, (None, "model", None))
    q, k, v = _qkv(p, cfg, xs, positions[r * rows:(r + 1) * rows],
                   _theta(cfg, kind))
    end = (r + 1) * rows
    k = C.all_gather_sum(k, 1, "model")
    v = C.all_gather_sum(v, 1, "model")
    y = attend_full(p, cfg, q, k[:, :end], v[:, :end], kind)
    y = shd.constrain(y, (), src=(None, "model", None))
    return (y, k, v) if with_kv else y


# ---------------------------------------------------------------------------
# prefill: the attention and the layer's decode cache
# ---------------------------------------------------------------------------

def attention_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, kind: str, max_len: int,
                      spec: Optional[dict] = None,
                      draws: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None):
    """(the attention's output, the layer's decode cache): q, k and v are
    projected once and serve both.  On a mesh the attention takes
    ``attention_full``'s path (sequence- or tensor-parallel) and the cache
    is this rank's shard, laid out by ``spec`` (the entry's
    ``sharding.cache_shardings``, ``{"k": spec, "v": spec}`` or the
    landmark factors')."""
    on_mesh = shd.mesh_active()
    if on_mesh and spec is None:
        raise ValueError("a prefill on a mesh takes its cache entry's specs")
    if cfg.use_mla:
        return _mla_prefill(params, cfg, x, positions, max_len, spec)
    split = False                          # k, v hold this rank's kv heads
    if _sp_active(cfg, x.shape[1]):
        h, k, v = _attention_sp(params, cfg, x, positions, kind, True)
    elif shd.split(params, "wq", 1):
        h, k, v = _attention_tp(params, cfg, x, positions, kind, True)
        split = shd.split(params, "wk", 1)
    else:
        q, k, v = _qkv(params, cfg, x, positions, _theta(cfg, kind))
        h = attend_full(params, cfg, q, k, v, kind)
        del q
    if not on_mesh:
        return h, prefill_cache(cfg, kind, k, v, max_len, draws, generator)
    return h, _mesh_prefill_cache(cfg, kind, k, v, max_len, spec, split,
                                  draws, generator)


def prefill_cache(cfg: ModelConfig, kind: str, k: torch.Tensor,
                  v: torch.Tensor, max_len: int, draws: Optional[dict] = None,
                  generator: Optional[torch.Generator] = None) -> dict:
    """The decode cache of one attention layer from its prefill k, v
    (B, S, KV, D): the landmark factors, the ring of the last W positions
    (each in its slot src % W), or the keys padded to ``max_len``."""
    B, S = k.shape[:2]
    if kind == "global" and cfg.use_landmark_decode:
        return build_landmark_cache(cfg, k, v, draws, generator)
    if kind == "local" and cfg.window is not None:
        W = min(cfg.window, max_len)
        src = torch.clamp(max(S - W, 0) + torch.arange(W, device=k.device),
                          0, S - 1)
        slots = src % W
        kr = torch.zeros((B, W) + k.shape[2:], dtype=k.dtype, device=k.device)
        vr = torch.zeros((B, W) + v.shape[2:], dtype=v.dtype, device=v.device)
        kr[:, slots] = k[:, src]
        vr[:, slots] = v[:, src]
        return {"k": kr, "v": vr}
    pad = max_len - S
    return {"k": torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)),
            "v": torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))}


def _mesh_prefill_cache(cfg: ModelConfig, kind: str, k: torch.Tensor,
                        v: torch.Tensor, max_len: int, spec: dict,
                        split: bool, draws: Optional[dict],
                        generator: Optional[torch.Generator]) -> dict:
    """This rank's shard of the layer's cache from its k, v: its own kv
    heads where ``split``, else every head; its batch rows.  Landmark
    draws from ``generator`` are those of one device: every rank draws the
    whole batch's, from every row's and head's K, and reads its own."""
    rows = shd.axis_index(shd.batch_axes()) * k.shape[0]
    if kind == "global" and cfg.use_landmark_decode:
        heads = None
        if split:
            first = shd.axis_index("model") * k.shape[2]
            heads = list(range(first, first + k.shape[2]))
        if draws is None:
            whole = C.all_gather(k, 2, "model") if split else k
            draws = landmark_draws(
                cfg, C.all_gather(whole, 0, shd.batch_axes()), generator)
            del whole
        st = build_landmark_cache(cfg, k, v, draws, rows=rows, heads=heads)
        # the factors are split by batch rows only: each rank built its kv
        # heads', so gather them over ``model``
        return {name: C.all_gather(t, 1, "model") if split else t
                for name, t in st.items()}
    entry = prefill_cache(cfg, kind, k, v, max_len)
    return {name: _cache_layout(t, spec[name], split)
            for name, t in entry.items()}


def _cache_layout(t: torch.Tensor, spec, split: bool) -> torch.Tensor:
    """t (B_loc, S, ·, D) or a latent (B_loc, S, R), this rank's kv heads
    (``split``) or every head,
    every position or ring slot -> its shard under ``spec``: its part of
    the positions (over the spec's sequence axes) and of the heads.  Heads
    to sequence is one all-to-all over ``model``."""
    mesh = shd.ambient_mesh()
    seq = _seq_axes(spec)
    by_head = "model" in shd._entry_axes(spec[2]) \
        and shd.ambient_axis_size("model") > 1
    if split and not by_head:
        if "model" in seq:
            outer = tuple(a for a in seq if a != "model")
            t = _narrow(t, 1, outer, mesh)          # this data group's part
            return C.heads_to_seq(t, "model").contiguous()
        t = C.all_gather(t, 2, "model")
    elif by_head and not split:
        t = _narrow(t, 2, ("model",), mesh)
    return _narrow(t, 1, seq, mesh).contiguous()


def _narrow(t: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    if not axes:
        return t
    first, n = shd.local_range((axes,), 0, t.shape[dim], mesh)
    return t.narrow(dim, first, n)


# ---------------------------------------------------------------------------
# MLA (deepseek): low-rank q and a latent kv cache
# ---------------------------------------------------------------------------

def _mla_project(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, seq_split: bool = False):
    """-> q_nope (B, S, H, dn), q_rope (B, S, H, dr) rotated, the latent
    ckv (B, S, R) and the shared rope key k_rope (B, S, dr) rotated, all in
    the compute dtype.

    On a mesh ``params`` may hold this rank's heads of ``wq_b`` (H is then
    its local heads) and its part of ``wq_a``'s q_rank columns: the low-rank
    query ql is all-gathered over ``model`` before its norm, and its
    gradient, partial on each rank (each reads ql through its own heads),
    summed back to the part.  Where the heads are whole, ``wq_a`` itself
    is gathered: the replicated body's gradient is taken at the part, or,
    with ``seq_split`` (each ``model`` rank projects its own rows:
    ``_mla_sp``), summed over the ranks back to it."""
    dt = cfg.cdtype
    dn, R = cfg.qk_nope_dim, cfg.kv_lora_rank
    wq_a = as_compute(params["wq_a"], dt)
    q_rank_split = shd.split(params, "wq_a", 1)
    heads = shd.split(params, "wq_b", 1)
    if q_rank_split and not heads:
        wq_a = (C.all_gather_sum if seq_split else C.gather)(wq_a, 1,
                                                             "model")
    ql = x @ wq_a
    if q_rank_split and heads:
        ql = C.all_gather_sum(ql, -1, "model")
    ql = L.rmsnorm(params["q_norm"], ql, cfg.norm_eps)
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
    projection.  The latents may be longer than the queries: B6
    right-aligns the queries to the keys (``_mla_sp``)."""
    dt = cfg.cdtype
    dn = cfg.qk_nope_dim
    H = q_nope.shape[2]
    kvb = _proj(ckv, params["wkv_b"], dt)                     # (B,Sk,H,dn+dv)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([kvb[..., :dn], k_rope[:, :, None].expand(-1, -1, H, -1)],
                   dim=-1)
    v = kvb[..., dn:]
    out = fa_ops.flash_attention(qf.transpose(1, 2), kf.transpose(1, 2),
                                 v.transpose(1, 2), causal=True)
    return _out_proj(out.transpose(1, 2), params["wo"], dt)


def _mla(params: dict, cfg: ModelConfig, x: torch.Tensor,
         positions: torch.Tensor):
    """(MLA's output, ckv (B, S, R), k_rope (B, S, dr)): the one-device
    body (``_mla_project``, ``mla_attend_full``).  With the heads split
    over ``model`` it runs on this rank's heads of ``wq_b``, ``wkv_b`` and
    ``wo`` and the partial output projection is summed over ``model``; the
    latent, from the replicated ``wkv_a``, is whole on every rank with no
    exchange.  Under sequence parallelism it is ``_mla_sp``."""
    if _sp_active(cfg, x.shape[1]):
        return _mla_sp(params, cfg, x, positions)
    tp = shd.split(params, "wq_b", 1)
    if tp:
        params, x = shd.tp_local(params), C.copy_to(x, "model")
    q_nope, q_rope, ckv, k_rope = _mla_project(params, cfg, x, positions)
    y = mla_attend_full(params, cfg, q_nope, q_rope, ckv, k_rope)
    return (C.reduce_from(y, "model") if tp else y), ckv, k_rope


def _mla_sp(params: dict, cfg: ModelConfig, x: torch.Tensor,
            positions: torch.Tensor):
    """Sequence-parallel MLA (``_sp_active``: the heads do not divide
    ``model``, the positions do), as ``_attention_sp`` for the other
    mixers.  The weights are whole on every rank but ``wq_a``, whose
    q_rank columns are gathered.  Each ``model`` rank projects its S/tp
    rows: its queries and its rows' latent (ckv, k_rope), at its positions.
    The latent, R + dr values a token against H·(dn + dr + dv) for K and
    V, is all-gathered once a layer; each rank expands it through
    ``wkv_b`` up to its last row and attends its queries against those
    keys (B6 right-aligns them), then the output rows are all-gathered
    back.  Returns (the output, the whole ckv, the whole k_rope)."""
    r, tp = shd.axis_index("model"), shd.ambient_axis_size("model")
    p = shd.tp_local(params)
    rows = x.shape[1] // tp
    xs = shd.constrain(x, (None, "model", None))
    q_nope, q_rope, ckv, k_rope = _mla_project(
        p, cfg, xs, positions[r * rows:(r + 1) * rows], seq_split=True)
    ckv = C.all_gather_sum(ckv, 1, "model")
    k_rope = C.all_gather_sum(k_rope, 1, "model")
    end = (r + 1) * rows
    y = mla_attend_full(p, cfg, q_nope, q_rope, ckv[:, :end],
                        k_rope[:, :end])
    return shd.constrain(y, (), src=(None, "model", None)), ckv, k_rope


def _mla_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, max_len: int,
                 spec: Optional[dict]):
    """(MLA's output, its latent cache padded to ``max_len``): on a mesh
    this rank's slice of it under ``spec`` (the latent is whole on every
    ``model`` rank, computed there or gathered under sequence
    parallelism, so the slice is a narrow)."""
    h, ckv, krope = _mla(params, cfg, x, positions)
    pad = (0, 0, 0, max_len - x.shape[1])
    cache = {"ckv": torch.nn.functional.pad(ckv, pad),
             "krope": torch.nn.functional.pad(krope, pad)}
    if spec is not None and shd.mesh_active():
        cache = {name: _cache_layout(t, spec[name], False)
                 for name, t in cache.items()}
    return h, cache


# ---------------------------------------------------------------------------
# cross-attention (the encoder-decoder's decoder)
# ---------------------------------------------------------------------------

def cross_attention(params: dict, cfg: ModelConfig, x: torch.Tensor,
                    enc_k: torch.Tensor, enc_v: torch.Tensor,
                    spec=None) -> torch.Tensor:
    """The decoder's x (B, S, d) against the encoder's K/V (B, S_enc, KV,
    D), precomputed by ``encoder_kv``: q projected (qk-norm, no RoPE), one
    non-causal flash-attention call, then the output projection.

    On a mesh with the heads split over ``model`` each rank projects its
    q heads against the K/V of its kv heads (as ``encoder_kv`` gives them,
    or a cache split by heads; of a whole cache it reads its own), and the
    partial output projection is summed over ``model``.  ``spec``, the
    layout of a cache of K/V, may split it by sequence: a decode step's
    q (of every head, all-gathered over ``model``) then reads the rank's
    positions, the partial reads merged by log-sum-exp in rank order
    (``collectives.lse_merge``), and the rank's heads leave through its
    part of ``wo``."""
    tp = shd.split(params, "wq", 1)
    seq = _seq_axes(spec)
    if tp:
        params, x = shd.tp_local(params), C.copy_to(x, "model")
    q = _proj(x, params["wq"], cfg.cdtype)
    if cfg.qk_norm:
        q = L.rmsnorm(params["q_norm"], q, cfg.norm_eps)
    if seq:
        h = q.shape[2]
        if tp:
            q = C.all_gather(q, 2, "model")
        valid = torch.ones((1, enc_k.shape[1]), dtype=torch.bool,
                           device=x.device)
        out = C.lse_merge(*_partial_read(q, enc_k, enc_v, valid), seq,
                          mesh=shd.ambient_mesh())
        out = out.reshape(q.shape[:3] + (-1,)).to(cfg.cdtype)
        if tp:
            out = out.narrow(2, shd.axis_index("model") * h, h)
        y = _out_proj(out, params["wo"], cfg.cdtype)
    else:
        enc_k, enc_v = _rank_kv(params, cfg, q, enc_k, enc_v)
        y = attend_full(params, cfg, q, enc_k, enc_v, "attn", causal=False)
    return C.reduce_from(y, "model") if tp else y


def _seq_axes(spec) -> tuple:
    """The axes (of size > 1) that split the sequence (dimension 1) of a
    (B, S, ·) cache leaf under ``spec`` (none without one)."""
    if spec is None:
        return ()
    return tuple(a for a in shd._entry_axes(spec[1])
                 if shd.ambient_axis_size(a) > 1)


def encoder_kv(params: dict, cfg: ModelConfig, enc_out: torch.Tensor):
    """The cross-attention's K and V (B, S_enc, KV, D) of the encoder
    output, in the compute dtype (no RoPE).  On a mesh whose ``model``
    splits ``wk``/``wv`` by heads, those of this rank's kv heads."""
    dt = cfg.cdtype
    if shd.split(params, "wk", 1):
        params = shd.tp_local(params)
        enc_out = C.copy_to(enc_out, "model")
    k = _proj(enc_out, params["wk"], dt)
    v = _proj(enc_out, params["wv"], dt)
    if cfg.qk_norm:
        k = L.rmsnorm(params["k_norm"], k, cfg.norm_eps)
    return k, v


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
               device=None) -> dict:
    """Zero cache for one layer (prefill fills it)."""
    dt = cfg.cdtype
    kv, hd = cfg.n_kv_heads, cfg.head_dim

    def z(shape, dtype=dt):
        return L.filled(shape, dtype, device)

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


def _partial_read(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_valid: torch.Tensor, width: Optional[int] = None):
    """``_decode_read`` over a part of the keys, unnormalized: the max m
    (B, KV, G) of the valid logits (−inf where none is valid), the sum l
    of their exponentials (0 there) and o = Σ e^(logit − m)·v
    (B, KV, G, Dv), all f32; ``collectives.lse_merge`` combines them.  The
    logits are scaled by 1/√``width`` (q's width by default)."""
    B, _, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, KV, H // KV, D).to(_F32)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k.to(_F32)) \
        / ((width or D) ** 0.5)
    logits = torch.where(kv_valid[:, None, None, :], logits, -torch.inf)
    m = torch.amax(logits, dim=-1)
    p = torch.exp(logits - torch.where(torch.isinf(m), 0.0, m)[..., None])
    return m, torch.sum(p, dim=-1), torch.einsum("bkgs,bskd->bkgd", p,
                                                 v.to(_F32))


def attention_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache: dict, pos: int, kind: str = "attn"
                     ) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, d); ``pos`` the new token's position.  Returns (y, cache)
    with the cache updated in place.

    On a mesh a full or ring cache is this rank's shard under its specs
    (``cache.specs``, as a prefill on the mesh returns it; whole where it
    carries none).  Split by kv heads: the rank's q heads read its own kv
    heads.  Otherwise every head reads the rank's positions (or ring
    slots), merged over the sequence axes by log-sum-exp; the rank that
    holds position ``pos`` (slot ``pos % W``) writes the token's k and v,
    the others write nothing.  The heads of a tensor-parallel rank leave
    through its part of the output projection, summed over ``model``."""
    pos = int(pos)
    if _is_mla(cfg, kind):
        return _mla_decode(params, cfg, x, cache, pos), cache
    if kind == "global" and cfg.use_landmark_decode and "k_land" in cache:
        return _landmark_decode(params, cfg, x, cache, pos), cache
    spec = (getattr(cache, "specs", None) or {}).get("k", (None,) * 4)
    mesh = shd.ambient_mesh()
    tp = shd.split(params, "wq", 1)
    by_head = "model" in shd._entry_axes(spec[2]) \
        and shd.ambient_axis_size("model") > 1
    positions = torch.tensor([pos], device=x.device)
    q, k_new, v_new = _qkv(params, cfg, x, positions, _theta(cfg, kind))
    if not by_head:                        # every head reads the keys here
        if shd.split(params, "wk", 1):
            k_new = C.all_gather(k_new, 2, "model")
            v_new = C.all_gather(v_new, 2, "model")
        if tp:
            q = C.all_gather(q, 2, "model")
    kc, vc = cache["k"], cache["v"]
    seq = _seq_axes(spec)
    size = kc.shape[1] * shd.ambient_axis_size(seq)
    first = shd.local_range(spec, 1, size, mesh)[0]
    j = first + torch.arange(kc.shape[1], device=x.device)
    if kind == "local" and cfg.window is not None:
        slot = pos % size
        slot_pos = pos - torch.remainder(pos - j, size)
        valid = ((slot_pos >= 0) & (slot_pos <= pos))[None]   # (1, W)
    else:
        if pos >= size:
            raise IndexError(f"position {pos} past a cache of {size}")
        slot = pos
        valid = (j <= pos)[None]
    if first <= slot < first + kc.shape[1]:
        kc[:, slot - first] = k_new[:, 0].to(kc.dtype)
        vc[:, slot - first] = v_new[:, 0].to(vc.dtype)
    if seq:
        out = C.lse_merge(*_partial_read(q, kc, vc, valid), seq, mesh=mesh)
        out = out.reshape(q.shape[0], 1, q.shape[2], -1).to(cfg.cdtype)
    else:
        out = _decode_read(q, kc, vc, cfg, valid)
    if tp and not by_head:                 # this rank's heads
        h = params["wo"].shape[0]
        out = out.narrow(2, shd.axis_index("model") * h, h)
    y = _out_proj(out, params["wo"], cfg.cdtype)
    return (C.reduce_from(y, "model") if tp else y), cache


def _mla_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                cache: dict, pos: int) -> torch.Tensor:
    """One MLA decode step; writes the token's latents into the cache.

    ``mla_absorb``: attend in the latent space — q_nope·W_kᵀ against ckv
    plus q_rope against krope, the softmax and the read of ckv in f32
    einsums, then W_v.  Otherwise K and V are materialized from the whole
    latent cache and read as a full-cache decode does (``_decode_read``).
    Both use the scale 1/√(dn + dr) and mask positions after ``pos``.

    On a mesh the heads may be split over ``model`` (this rank's heads of
    ``wq_b``, ``wkv_b``, ``wo``; the partial output projection summed) and
    the cache, this rank's shard under ``cache.specs``, split by sequence:
    only the rank holding ``pos`` writes the token's latents.  Absorbed,
    the latent queries of every head ([q_lat; q_rope], all-gathered over
    ``model``) read this rank's positions, the partial reads merged by
    log-sum-exp over the sequence axes (``collectives.lse_merge``), and
    each rank takes its heads' o_lat through its W_v.  Materialized, the
    latent slices are all-gathered over the sequence axes first."""
    dt = cfg.cdtype
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    spec = (getattr(cache, "specs", None) or {}).get("ckv", (None,) * 3)
    mesh = shd.ambient_mesh()
    tp = shd.split(params, "wq_b", 1)
    if tp:
        params, x = shd.tp_local(params), C.copy_to(x, "model")
    positions = torch.tensor([pos], device=x.device)
    q_nope, q_rope, ckv_new, krope_new = _mla_project(params, cfg, x,
                                                      positions)
    ckv, krope = cache["ckv"], cache["krope"]
    seq = _seq_axes(spec)
    S = ckv.shape[1] * shd.ambient_axis_size(seq)
    if pos >= S:
        raise IndexError(f"position {pos} past a cache of {S}")
    first = shd.local_range(spec, 1, S, mesh)[0]
    if first <= pos < first + ckv.shape[1]:
        ckv[:, pos - first] = ckv_new[:, 0].to(ckv.dtype)
        krope[:, pos - first] = krope_new[:, 0].to(krope.dtype)
    wkv_b = as_compute(params["wkv_b"], dt)                    # (R,H,dn+dv)
    w_k, w_v = wkv_b[..., :dn], wkv_b[..., dn:]
    if seq and not cfg.mla_absorb:         # the whole latent, every rank
        ckv = C.all_gather(ckv, 1, seq, mesh=mesh)
        krope = C.all_gather(krope, 1, seq, mesh=mesh)
        first, seq = 0, ()
    valid = first + torch.arange(ckv.shape[1], device=x.device) <= pos
    if cfg.mla_absorb:
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, w_k)
        if seq:
            o_lat = _mla_merged_read(cfg, q_lat, q_rope, ckv, krope, valid,
                                     seq, mesh, tp)
        else:
            s_lat = torch.einsum("bshr,btr->bhst", q_lat.to(_F32),
                                 ckv.to(_F32))
            s_rope = torch.einsum("bshk,btk->bhst", q_rope.to(_F32),
                                  krope.to(_F32))
            logits = (s_lat + s_rope) / ((dn + dr) ** 0.5)
            logits = torch.where(valid[None, None, None, :], logits, NEG)
            w = torch.softmax(logits, dim=-1)                  # (B,H,1,S)
            o_lat = torch.einsum("bhst,btr->bshr", w, ckv.to(_F32))
        out = torch.einsum("bshr,rhk->bshk", o_lat, w_v.to(_F32))
    else:
        k_nope = torch.einsum("btr,rhk->bthk", ckv, w_k)
        v = torch.einsum("btr,rhk->bthk", ckv, w_v)
        kf = torch.cat([k_nope, krope[:, :, None].expand(
            k_nope.shape[:3] + (dr,))], dim=-1)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        out = _decode_read(qf, kf, v, cfg, valid[None])
    y = _out_proj(out.to(dt), params["wo"], dt)
    return C.reduce_from(y, "model") if tp else y


def _mla_merged_read(cfg: ModelConfig, q_lat: torch.Tensor,
                     q_rope: torch.Tensor, ckv: torch.Tensor,
                     krope: torch.Tensor, valid: torch.Tensor, seq, mesh,
                     tp: bool) -> torch.Tensor:
    """The absorbed read of a latent cache split by sequence over ``seq``:
    [q_lat; q_rope] (B, 1, H_loc, R + dr) of every head (all-gathered over
    ``model`` where ``tp``) against this rank's [ckv; krope] as one shared
    key head, the partial reads merged by log-sum-exp -> o_lat (B, 1,
    H_loc, R) f32 of this rank's heads."""
    qa = torch.cat([q_lat, q_rope], dim=-1)
    if tp:
        qa = C.all_gather(qa, 2, "model", mesh=mesh)
    part = _partial_read(qa, torch.cat([ckv, krope], dim=-1)[:, :, None],
                         ckv[:, :, None], valid[None],
                         width=cfg.qk_nope_dim + cfg.qk_rope_dim)
    o_lat = C.lse_merge(*part, seq, mesh=mesh).reshape(
        qa.shape[:3] + (ckv.shape[-1],))
    if tp:
        h = q_lat.shape[2]
        o_lat = o_lat.narrow(2, shd.axis_index("model") * h, h)
    return o_lat


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
    tp = shd.split(params, "wq", 1)
    fac = {name: cache[name] for name in ("k_land", "uv", "u1", "offset")}
    if tp:      # the factors are whole over ``model``: this rank's heads'
        idx = _kv_heads_of(shd.axis_index("model"), q.shape[1], cfg)
        fac = {name: t[:, idx] for name, t in fac.items()}
    KV = fac["k_land"].shape[1]
    B, H, D = q.shape
    qg = q.reshape(B, KV, H // KV, D).to(_F32)
    kl = fac["k_land"].to(_F32)                                # (B,KV,c,D)
    logits = torch.einsum("bkgd,bkcd->bkgc", qg, kl) / (D ** 0.5)
    cvec = torch.exp(logits - fac["offset"][:, :, None, None])
    num = torch.einsum("bkgc,bkcv->bkgv", cvec, fac["uv"].to(_F32))
    den = torch.einsum("bkgc,bkc->bkg", cvec, fac["u1"])
    out = num / signed_den_floor(den)[..., None]
    out = out.reshape(B, 1, H, out.shape[-1]).to(dt)
    y = _out_proj(out, params["wo"], dt)
    return C.reduce_from(y, "model") if tp else y


def build_landmark_cache(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                         draws: Optional[dict] = None,
                         generator: Optional[torch.Generator] = None,
                         rows: int = 0, heads=None) -> dict:
    """Prefill-side landmark cache from the full K/V (B, S, KV, D): the
    paper's Algorithm 1 on the softmax Gram, per (batch row, kv head).

    ``draws`` = {"p_idx": (B, KV, c), "skx": (B, KV, s)} gives the landmark
    and column-sketch indices of every head; without them each head draws
    its own from ``generator`` (``landmark_draws``).  k and v stay in the
    compute dtype, as the reference passes them.  On a mesh k and v may
    hold a part of the batch and of the heads: their rows are the batch's
    ``rows`` on, their heads ``heads`` (global ids; all by default), and
    the draws, of the whole batch, are read there.
    """
    B, S, KV, _ = k.shape
    heads = list(range(KV)) if heads is None else list(heads)
    if draws is None:
        if rows or len(heads) != KV:
            raise ValueError("a part of the batch reads the whole batch's "
                             "landmark draws")
        draws = landmark_draws(cfg, k, generator)
    outs = {"k_land": [], "uv": [], "u1": [], "offset": []}
    for b in range(B):
        for j, h in enumerate(heads):
            st = build_landmark_state(
                k[b, :, j], v[b, :, j], cfg.landmark_c, cfg.landmark_theta,
                cfg.landmark_selection, device=k.device,
                **{name: draws[name][rows + b][h]
                   for name in ("p_idx", "skx")})
            for name, t in zip(outs, st):
                outs[name].append(t)
    return {name: torch.stack(ts).unflatten(0, (B, KV))
            for name, ts in outs.items()}


def landmark_draws(cfg: ModelConfig, k: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> dict:
    """{"p_idx": (B, KV, c), "skx": (B, KV, s)}: the landmark and
    column-sketch indices that each head of k (B, S, KV, D) draws from
    ``generator`` (a new one of the default seed where None), in (batch
    row, kv head) order."""
    g = generator_or_default(generator)
    B, _, KV, _ = k.shape
    pairs = [SA.landmark_draws(k[b, :, h], cfg.landmark_c,
                               cfg.landmark_theta, cfg.landmark_selection,
                               generator=g)
             for b in range(B) for h in range(KV)]
    return {name: torch.stack([p[i] for p in pairs]).unflatten(0, (B, KV))
            for i, name in enumerate(("p_idx", "skx"))}
