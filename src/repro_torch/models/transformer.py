"""Block assembly for attention blocks, dense or MoE: residual blocks and
stacks (port of ``repro.models.transformer``).

A stack is ``prefix`` blocks + ``reps`` superblocks (one pass through
``cfg.layer_pattern`` each) + ``remainder`` blocks, as in the reference.
The reference scans the superblocks over parameters stacked on a leading
``reps`` axis; here they are a list of ``reps`` tuples of block dicts and a
Python loop walks them.  Caches mirror the parameters:
``{"prefix": [...], "scanned": [[... per pattern slot] per rep],
"remainder": [...]}``.

Prefix blocks are dense (at ``dense_d_ff`` when set: deepseek's first 3);
the superblocks and the remainder are MoE when ``n_experts > 0``.

Every block has three modes:
  full    : (x) -> (x', aux)           aux: the MoE load-balance loss, 0
  prefill : (x) -> (x', cache_entry)   cache sized ``max_len``
  decode  : (x, cache_entry, pos) -> (x', cache_entry)   (updated in place)

Recurrent blocks (mLSTM, sLSTM, RG-LRU) are not ported yet and raise
``NotImplementedError`` (ROADMAP A11-rest.3).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M

ATTN_KINDS = ("attn", "local", "global")
REC_KINDS = ("mlstm", "slstm", "rglru")


def _check_kind(kind: str) -> None:
    if kind in REC_KINDS:
        raise NotImplementedError(
            f"recurrent blocks ({kind}) are not in the port yet "
            "(ROADMAP A11-rest.3)")
    if kind not in ATTN_KINDS:
        raise ValueError(kind)


def _is_moe_layer(cfg: ModelConfig, in_prefix: bool) -> bool:
    return cfg.n_experts > 0 and not in_prefix


def _has_mlp(cfg: ModelConfig, moe: bool) -> bool:
    return moe or cfg.d_ff > 0 or cfg.dense_d_ff > 0


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

def init_block(generator: torch.Generator, cfg: ModelConfig, kind: str,
               moe: bool = False, dense_ff: Optional[int] = None,
               device=None) -> dict:
    _check_kind(kind)
    pd = cfg.pdtype
    p = {"norm1": L.init_rmsnorm(cfg.d_model, pd, device),
         "mixer": A.init_attention(generator, cfg, device)}
    if cfg.post_norm:
        p["post_norm1"] = L.init_rmsnorm(cfg.d_model, pd, device)
    if _has_mlp(cfg, moe):
        p["norm2"] = L.init_rmsnorm(cfg.d_model, pd, device)
        if moe:
            p["moe"] = M.init_moe(generator, cfg, device)
        else:
            p["mlp"] = L.init_mlp(generator, cfg, d_ff=dense_ff,
                                  device=device)
        if cfg.post_norm:
            p["post_norm2"] = L.init_rmsnorm(cfg.d_model, pd, device)
    return p


def _residual_mlp(params: dict, cfg: ModelConfig, x: torch.Tensor,
                  h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x + post_norm1(h), then the MLP or MoE sub-block (if any) with its
    own residual.  Returns (x', aux): the MoE's load-balance loss, else 0."""
    if cfg.post_norm:
        h = L.rmsnorm(params["post_norm1"], h, cfg.norm_eps)
    x = x + h
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "mlp" in params or "moe" in params:
        h = L.rmsnorm(params["norm2"], x, cfg.norm_eps)
        if "moe" in params:
            h, aux = M.moe_ffn(params["moe"], cfg, h)
        else:
            h = L.mlp(params["mlp"], cfg, h)
        if cfg.post_norm:
            h = L.rmsnorm(params["post_norm2"], h, cfg.norm_eps)
        x = x + h
    return x, aux


def block_full(params: dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
               positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_kind(kind)
    h = A.attention_full(params["mixer"], cfg,
                         L.rmsnorm(params["norm1"], x, cfg.norm_eps),
                         positions, kind)
    return _residual_mlp(params, cfg, x, h)


def block_prefill(params: dict, cfg: ModelConfig, kind: str,
                  x: torch.Tensor, positions: torch.Tensor, max_len: int,
                  draws: Optional[dict] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, dict]:
    """Returns (x', cache_entry).  The projections are made once and serve
    both the attention and the cache (the reference projects them twice;
    the two are the same computation): q, k and v, or under MLA the
    latents ckv and the rope key, which are MLA's cache."""
    _check_kind(kind)
    xin = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
    if cfg.use_mla:
        parts = A._mla_project(params["mixer"], cfg, xin, positions)
        h = A.mla_attend_full(params["mixer"], cfg, *parts)
        pad = (0, 0, 0, max_len - x.shape[1])
        cache = {"ckv": torch.nn.functional.pad(parts[2], pad),
                 "krope": torch.nn.functional.pad(parts[3], pad)}
        del parts
    else:
        q, k, v = A._qkv(params["mixer"], cfg, xin, positions,
                         A._theta(cfg, kind))
        h = A.attend_full(params["mixer"], cfg, q, k, v, kind)
        del q
        cache = _attn_prefill_cache(cfg, kind, k, v, max_len, draws,
                                    generator)
        del k, v
    return _residual_mlp(params, cfg, x, h)[0], cache


def _attn_prefill_cache(cfg: ModelConfig, kind: str, k: torch.Tensor,
                        v: torch.Tensor, max_len: int,
                        draws: Optional[dict] = None,
                        generator: Optional[torch.Generator] = None) -> dict:
    """The decode cache of one attention layer from its prefill k, v
    (B, S, KV, D)."""
    B, S = k.shape[:2]
    if kind == "global" and cfg.use_landmark_decode:
        return A.build_landmark_cache(cfg, k, v, draws, generator)
    if kind == "local" and cfg.window is not None:
        # the last W positions, each in its ring slot src % W
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


def block_decode(params: dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                 cache: dict, pos: int) -> Tuple[torch.Tensor, dict]:
    _check_kind(kind)
    h, cache = A.attention_decode(
        params["mixer"], cfg, L.rmsnorm(params["norm1"], x, cfg.norm_eps),
        cache, pos, kind)
    return _residual_mlp(params, cfg, x, h)[0], cache


# ---------------------------------------------------------------------------
# stacks (prefix + superblocks + remainder)
# ---------------------------------------------------------------------------

def stack_layout(cfg: ModelConfig):
    """-> (prefix_kinds, pattern, n_repeats, remainder_kinds)."""
    pattern = tuple(cfg.layer_pattern)
    prefix = tuple(pattern[i % len(pattern)]
                   for i in range(cfg.first_k_dense))
    n_rest = cfg.n_layers - cfg.first_k_dense
    reps = n_rest // len(pattern)
    remainder = pattern[: n_rest % len(pattern)]
    return prefix, pattern, reps, remainder


def layer_slots(cfg: ModelConfig) -> List[Tuple[str, int, int, str]]:
    """Every layer in order as (section, rep, slot, kind); a layer's flat
    index is its place in this list (the key of ``landmark_draws``)."""
    prefix, pattern, reps, remainder = stack_layout(cfg)
    return ([("prefix", 0, i, kd) for i, kd in enumerate(prefix)]
            + [("scanned", r, i, kd) for r in range(reps)
               for i, kd in enumerate(pattern)]
            + [("remainder", 0, i, kd) for i, kd in enumerate(remainder)])


def _entry(tree: dict, section: str, r: int, i: int):
    return tree[section][r][i] if section == "scanned" else tree[section][i]


def _empty_like_layout(cfg: ModelConfig) -> dict:
    _, _, reps, _ = stack_layout(cfg)
    return {"prefix": [], "scanned": [[] for _ in range(reps)],
            "remainder": []}


def _append(tree: dict, section: str, r: int, value) -> None:
    (tree[section][r] if section == "scanned" else tree[section]).append(
        value)


def init_stack(generator: torch.Generator, cfg: ModelConfig,
               device=None) -> dict:
    params = _empty_like_layout(cfg)
    for section, r, _, kind in layer_slots(cfg):
        in_prefix = section == "prefix"
        dense_ff = (cfg.dense_d_ff or None) if in_prefix else None
        _append(params, section, r,
                init_block(generator, cfg, kind,
                           _is_moe_layer(cfg, in_prefix), dense_ff, device))
    return params


def stack_full(params: dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, the sum of the blocks' aux losses)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for section, r, i, kind in layer_slots(cfg):
        x, a = block_full(_entry(params, section, r, i), cfg, kind, x,
                          positions)
        aux = aux + a
    return x, aux


def stack_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, max_len: int,
                  landmark_draws: Optional[Dict[int, dict]] = None,
                  generator: Optional[torch.Generator] = None):
    """Returns (x, caches).  ``landmark_draws`` maps a landmark layer's flat
    index (``layer_slots``) to its draws; a layer without an entry draws
    from ``generator``."""
    caches = _empty_like_layout(cfg)
    for n, (section, r, i, kind) in enumerate(layer_slots(cfg)):
        draws = None if landmark_draws is None else landmark_draws.get(n)
        x, c = block_prefill(_entry(params, section, r, i), cfg, kind, x,
                             positions, max_len, draws, generator)
        _append(caches, section, r, c)
    return x, caches


def stack_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 caches: dict, pos: int):
    for section, r, i, kind in layer_slots(cfg):
        x, _ = block_decode(_entry(params, section, r, i), cfg, kind, x,
                            _entry(caches, section, r, i), pos)
    return x, caches


def stack_cache(cfg: ModelConfig, batch: int, max_len: int,
                device=None) -> dict:
    cache = _empty_like_layout(cfg)
    for section, r, _, kind in layer_slots(cfg):
        _check_kind(kind)
        _append(cache, section, r,
                A.init_cache(cfg, kind, batch, max_len, device))
    return cache
