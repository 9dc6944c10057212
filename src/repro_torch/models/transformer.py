"""Block assembly for attention blocks (dense or MoE) and recurrent blocks
(RG-LRU, mLSTM, sLSTM): residual blocks and stacks (port of
``repro.models.transformer``).

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

On a mesh (``distributed.sharding.use_mesh``, params as ``MeshParams``)
each half-block all-gathers its FSDP-sharded weights as it starts
(``sharding.materialize``); under a checkpoint the recompute gathers them
again, so no gathered weight outlives its half-block.  Prefill and decode
run there too: each cache entry is this rank's shard, laid out by
``sharding.cache_shardings`` (``attention.attention_prefill``,
``attention.attention_decode``).

A recurrent block's cache entry is its mixer's decode state (RG-LRU
``h``/``conv``, mLSTM ``C``/``n``/``m``, sLSTM ``c``/``n``/``h``/``m``).
Prefill takes it from the mixer's full pass (``recurrent.*_prefill``); the
reference's per-token decode scan over the prompt is kept as
``_rec_prefill_state``, the oracle.  mLSTM and sLSTM blocks have no MLP.
On a mesh the recurrent mixers run their own mesh paths
(``models.recurrent``) and lay their states out by
``sharding.state_pspec``, the rule ``cache_shardings`` gives those leaves:
the entry a recurrent block returns and takes is this rank's shard.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R

ATTN_KINDS = ("attn", "local", "global")
REC_KINDS = ("mlstm", "slstm", "rglru")


def _check_kind(kind: str) -> None:
    if kind not in ATTN_KINDS + REC_KINDS:
        raise ValueError(kind)


def _is_moe_layer(cfg: ModelConfig, in_prefix: bool) -> bool:
    return cfg.n_experts > 0 and not in_prefix


def _has_mlp(cfg: ModelConfig, kind: str, moe: bool) -> bool:
    if kind in ("mlstm", "slstm"):
        return False                                          # xLSTM blocks
    return moe or cfg.d_ff > 0 or cfg.dense_d_ff > 0


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

def init_block(generator: torch.Generator, cfg: ModelConfig, kind: str,
               moe: bool = False, dense_ff: Optional[int] = None,
               device=None) -> dict:
    _check_kind(kind)
    pd = cfg.pdtype
    init_mixer = R.INIT[kind] if kind in REC_KINDS else A.init_attention
    p = {"norm1": L.init_rmsnorm(cfg.d_model, pd, device),
         "mixer": init_mixer(generator, cfg, device)}
    if cfg.post_norm:
        p["post_norm1"] = L.init_rmsnorm(cfg.d_model, pd, device)
    if _has_mlp(cfg, kind, moe):
        p["norm2"] = L.init_rmsnorm(cfg.d_model, pd, device)
        if moe:
            p["moe"] = M.init_moe(generator, cfg, device)
        else:
            p["mlp"] = L.init_mlp(generator, cfg, d_ff=dense_ff,
                                  device=device)
        if cfg.post_norm:
            p["post_norm2"] = L.init_rmsnorm(cfg.d_model, pd, device)
    return p


def _mlp_residual(params: dict, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MLP or MoE sub-block (if any) with its own residual.  Returns
    (x', aux): the MoE's load-balance loss, else 0."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "mlp" in params or "moe" in params:
        params = shd.materialize(params, ("norm2", "mlp", "moe",
                                          "post_norm2"))
        h = L.rmsnorm(params["norm2"], x, cfg.norm_eps)
        if "moe" in params:
            h, aux = M.moe_ffn(params["moe"], cfg, h)
        else:
            h = L.mlp(params["mlp"], cfg, h)
        if cfg.post_norm:
            h = L.rmsnorm(params["post_norm2"], h, cfg.norm_eps)
        x = x + h
    return x, aux


def _residual_mlp(params: dict, cfg: ModelConfig, x: torch.Tensor,
                  h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x + post_norm1(h), then ``_mlp_residual``; the normed h is freed
    before the MLP runs."""
    if cfg.post_norm:
        h = L.rmsnorm(params["post_norm1"], h, cfg.norm_eps)
    x = x + h
    del h
    return _mlp_residual(params, cfg, x)


def _encoder_attention(params: dict, cfg: ModelConfig, x: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
    """Bidirectional self-attention (the encoder-decoder's encoder): q, k,
    v rotated at ``rope_theta`` as any self-attention's, one non-causal
    flash-attention call, no window.  On a mesh whose ``model`` splits the
    heads, each rank's heads (``attention._attention_tp``)."""
    if shd.split(params, "wq", 1):
        return A._attention_tp(params, cfg, x, positions, "attn",
                               causal=False)
    q, k, v = A._qkv(params, cfg, x, positions, cfg.rope_theta)
    return A.attend_full(params, cfg, q, k, v, "attn", causal=False)


def _mixer_residual(params: dict, cfg: ModelConfig, kind: str,
                    x: torch.Tensor, positions: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """The block's first half: x + post_norm1(mixer(norm1(x)))."""
    params = shd.materialize(params, ("norm1", "mixer", "post_norm1"))
    xin = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
    if kind in REC_KINDS:
        h = R.FULL[kind](params["mixer"], cfg, xin)
    elif not causal:
        h = _encoder_attention(params["mixer"], cfg, xin, positions)
    else:
        h = A.attention_full(params["mixer"], cfg, xin, positions, kind)
    if cfg.post_norm:
        h = L.rmsnorm(params["post_norm1"], h, cfg.norm_eps)
    return x + h


def block_full(params: dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
               positions: torch.Tensor, causal: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``causal=False`` makes an attention block's mixer bidirectional
    (``_encoder_attention``), as the reference's encoder runs."""
    _check_kind(kind)
    return _mlp_residual(params, cfg, _mixer_residual(params, cfg, kind, x,
                                                      positions, causal))


def block_prefill(params: dict, cfg: ModelConfig, kind: str,
                  x: torch.Tensor, positions: torch.Tensor, max_len: int,
                  draws: Optional[dict] = None,
                  generator: Optional[torch.Generator] = None,
                  spec: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """Returns (x', cache_entry).  The projections are made once and serve
    both the attention and the cache (the reference projects them twice;
    the two are the same computation): q, k and v, or under MLA the
    latents ckv and the rope key, which are MLA's cache.  A recurrent
    block's cache is its mixer's state after the last token, from the full
    pass (the reference rebuilds it by ``_rec_prefill_state``).  On a mesh
    the attention takes its tensor- or sequence-parallel path (MLA its
    heads over ``model``: ``attention.attention_prefill``) and the entry is
    this rank's shard under ``spec``, the entry's cache specs."""
    _check_kind(kind)
    mp = shd.materialize(params, ("norm1", "mixer"))
    xin = L.rmsnorm(mp["norm1"], x, cfg.norm_eps)
    if kind in REC_KINDS:
        h, cache = R.PREFILL[kind](mp["mixer"], cfg, xin)
    else:
        h, cache = A.attention_prefill(mp["mixer"], cfg, xin, positions,
                                       kind, max_len, spec, draws, generator)
    del mp
    return _residual_mlp(params, cfg, x, h)[0], cache


def _rec_prefill_state(mp: dict, cfg: ModelConfig, kind: str,
                       xin: torch.Tensor) -> dict:
    """The final recurrent state by a per-token decode scan over the input,
    as the reference computes it at prefill: one decode step a token, so
    the plain oracle of the state ``block_prefill`` takes from the full
    pass."""
    state = R.INIT_STATE[kind](cfg, xin.shape[0], xin.device)
    for t in range(xin.shape[1]):
        R.DECODE[kind](mp, cfg, xin[:, t:t + 1], state)
    return state


def block_decode(params: dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                 cache: dict, pos: int) -> Tuple[torch.Tensor, dict]:
    """The cache entry is updated in place: an attention layer writes the
    token's k and v (or latents) into it, a recurrent layer replaces its
    state's tensors."""
    _check_kind(kind)
    mp = shd.materialize(params, ("norm1", "mixer"))
    xin = L.rmsnorm(mp["norm1"], x, cfg.norm_eps)
    if kind in REC_KINDS:
        h, cache = R.DECODE[kind](mp["mixer"], cfg, xin, cache)
    else:
        h, cache = A.attention_decode(mp["mixer"], cfg, xin, cache, pos,
                                      kind)
    del mp
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


#: the matrix products ``"dots"`` saves (what ``@``, ``einsum`` and
#: ``matmul`` reach at the ATen level): ``checkpoint_dots`` saves every
#: ``dot_general``
_DOT_OPS = frozenset({torch.ops.aten.mm, torch.ops.aten.addmm,
                      torch.ops.aten.bmm, torch.ops.aten.baddbmm,
                      torch.ops.aten.mv, torch.ops.aten.dot})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_dots():
    return create_selective_checkpoint_contexts(_dots_policy)


def _block_save_io(params: dict, cfg: ModelConfig, kind: str,
                   x: torch.Tensor, positions: torch.Tensor,
                   causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """``block_full`` under ``"save_io"``: one checkpoint for the mixer half
    and one for the MLP half, so what the block keeps is its input and
    each half's output: x + mixer_out and x + mixer_out + mlp_out, the
    reference's saved ``mixer_out`` / ``mlp_out`` up to the residual adds
    (its inputs are kept anyway).  The backward of the MLP half recomputes
    no mixer."""
    _check_kind(kind)
    x = checkpoint(shd.bind_mesh(_mixer_residual), params, cfg, kind, x,
                   positions, causal, use_reentrant=False)
    if "mlp" not in params and "moe" not in params:
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    return checkpoint(shd.bind_mesh(_mlp_residual), params, cfg, x,
                      use_reentrant=False)


def _remat(cfg: ModelConfig, x: torch.Tensor):
    """The block function under ``cfg.remat`` when the stack's input ``x``
    carries a gradient (training); serving gets ``block_full``.  The
    reference remats each pattern period with ``jax.checkpoint``; here
    each block is checkpointed (non-reentrant ``torch.utils.checkpoint``),
    the same function:

    - ``"none"``: no checkpoint, every activation saved;
    - ``"dots"`` (``checkpoint_dots``): a selective checkpoint that saves
      the outputs of the matrix products (``_DOT_OPS``) and recomputes the
      rest;
    - ``"save_io"`` (``save_only_these_names("mixer_out", "mlp_out")``):
      ``_block_save_io``.  Two checkpoints, not a tag the selective policy
      would save: the block code stays one function with no tagging op,
      and the saved set is the reference's up to the residual adds;
    - ``"full"``, and any other name as in the reference: the block's
      input alone is saved, the whole block recomputed in the backward.

    A policy changes memory and time, never the value."""
    if not (torch.is_grad_enabled() and x.requires_grad) \
            or cfg.remat == "none":
        return block_full
    if cfg.remat == "save_io":
        return _block_save_io
    if cfg.remat == "dots":
        return functools.partial(checkpoint, shd.bind_mesh(block_full),
                                 use_reentrant=False, context_fn=_save_dots)
    return functools.partial(checkpoint, shd.bind_mesh(block_full),
                             use_reentrant=False)


def stack_full(params: dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, causal: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, the sum of the blocks' aux losses).  In training each
    block is rematerialized as ``cfg.remat`` says (``_remat``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = _remat(cfg, x)
    for section, r, i, kind in layer_slots(cfg):
        x, a = block(_entry(params, section, r, i), cfg, kind, x, positions,
                     causal)
        aux = aux + a
    return x, aux


def stack_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, max_len: int,
                  landmark_draws: Optional[Dict[int, dict]] = None,
                  generator: Optional[torch.Generator] = None,
                  cache_specs: Optional[dict] = None):
    """Returns (x, caches).  ``landmark_draws`` maps a landmark layer's flat
    index (``layer_slots``) to its draws; a layer without an entry draws
    from ``generator``.  On a mesh ``cache_specs`` is the whole cache's
    ``sharding.cache_shardings`` and each entry this rank's shard."""
    caches = _empty_like_layout(cfg)
    for n, (section, r, i, kind) in enumerate(layer_slots(cfg)):
        draws = None if landmark_draws is None else landmark_draws.get(n)
        spec = None if cache_specs is None \
            else _entry(cache_specs, section, r, i)
        x, c = block_prefill(_entry(params, section, r, i), cfg, kind, x,
                             positions, max_len, draws, generator, spec)
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
                R.INIT_STATE[kind](cfg, batch, device) if kind in REC_KINDS
                else A.init_cache(cfg, kind, batch, max_len, device))
    return cache
