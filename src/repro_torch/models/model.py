"""The decoder-only LM (port of ``repro.models.model``): the dense, MoE and
MLA attention families and chameleon's early fusion.  Serving only: the
loss and the MTP head's loss come with training (ROADMAP A11-rest.5), the
encoder-decoder with A11-rest.4.

``build_model(cfg)`` -> ``Model`` with the serving entry points:

  init(generator, device)                  -> params  (cfg.pdtype)
  prepare(params)                          -> params with matmul weights
                                              in cfg.cdtype, cast once
  forward(params, batch)                   -> (logits, aux)
  prefill(params, batch, max_len, *, landmark_draws, generator)
                                           -> (last_logits, cache)
  decode_step(params, cache, tokens, pos)  -> (logits, cache)
  cache_shape(batch, max_len, device)      -> zero cache

``batch`` is ``{"tokens": (B, S) int}``, and for early fusion also
``"patches"`` (B, n_patch, d_model): precomputed patch embeddings that
replace the leading n_patch positions in ``forward`` and ``prefill``.
``forward``'s aux is the sum of the MoE blocks' load-balance losses (0 for
a dense model).  A config with ``mtp`` gets the reference's ``"mtp"``
sub-tree at ``init`` (so the trees match); serving never reads it.

Randomness is explicit: ``init`` draws from a ``torch.Generator``, and
``prefill`` takes the landmark layers' draws (``landmark_draws``, see
``transformer.stack_prefill``) or draws them from ``generator``.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import generator_or_default, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

#: parameter names of the matmul weights, cast by ``prepare``; the rest (norm
#: scales, and the MoE ``router``, which computes in f32) keep their dtype
MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "wi_gate", "wi_up", "embedding",
                  "unembed", "wq_a", "wq_b", "wkv_a", "wkv_b", "proj")


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable
    prepare: Callable
    forward: Callable
    prefill: Callable
    decode_step: Callable
    cache_shape: Callable


def _init_lm(generator: Optional[torch.Generator] = None, device=None, *,
             cfg: ModelConfig) -> dict:
    device = resolve_device(device)
    g = generator_or_default(generator)
    params = {"embed": L.init_embed(g, cfg, device),
              "stack": T.init_stack(g, cfg, device),
              "final_norm": L.init_rmsnorm(cfg.d_model, cfg.pdtype, device)}
    if cfg.mtp:
        d, pd = cfg.d_model, cfg.pdtype
        params["mtp"] = {
            "proj": L.dense_init(g, (2 * d, d), pd, device=device),
            "norm_h": L.init_rmsnorm(d, pd, device),
            "norm_e": L.init_rmsnorm(d, pd, device),
            "block": T.init_block(g, cfg, "attn", moe=False,
                                  dense_ff=cfg.dense_d_ff or None,
                                  device=device),
            "final_norm": L.init_rmsnorm(d, pd, device),
        }
    return params


def _prepare(params, cfg: ModelConfig):
    """The same params with every matmul weight in the compute dtype, cast
    once (the reference casts per call; the numbers are the same).  Norm
    scales keep their dtype: the norms compute in f32."""
    if isinstance(params, dict):
        return {k: (L.as_compute(v, cfg.cdtype) if k in MATMUL_WEIGHTS
                    and isinstance(v, torch.Tensor) else _prepare(v, cfg))
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_prepare(v, cfg) for v in params]
    return params


def _tokens(batch: dict, device) -> torch.Tensor:
    return torch.as_tensor(batch["tokens"], dtype=torch.int64,
                           device=device)


def _device(params: dict) -> torch.device:
    return params["embed"]["embedding"].device


def _embed_inputs(params: dict, cfg: ModelConfig, batch: dict
                  ) -> torch.Tensor:
    """Token embeddings; a ``"patches"`` entry (B, n_patch, d_model)
    replaces the leading n_patch positions (early fusion)."""
    device = _device(params)
    x = L.embed(params["embed"], cfg, _tokens(batch, device))
    if "patches" in batch:
        patches = torch.as_tensor(batch["patches"], device=device).to(
            cfg.cdtype)
        x = torch.cat([patches, x[:, patches.shape[1]:]], dim=1)
    return x


def _lm_forward(params: dict, batch: dict, *, cfg: ModelConfig):
    x = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = T.stack_full(params["stack"], cfg, x, positions)
    h = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], cfg, h), aux


def _lm_prefill(params: dict, batch: dict, max_len: int, *,
                cfg: ModelConfig,
                landmark_draws: Optional[Dict[int, dict]] = None,
                generator: Optional[torch.Generator] = None):
    x = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, caches = T.stack_prefill(params["stack"], cfg, x, positions, max_len,
                                landmark_draws, generator)
    h_last = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return L.unembed(params["embed"], cfg, h_last)[:, 0], caches


def _lm_decode(params: dict, cache: dict, tokens, pos: int, *,
               cfg: ModelConfig):
    x = L.embed(params["embed"], cfg, _tokens({"tokens": tokens},
                                              _device(params)))
    x, cache = T.stack_decode(params["stack"], cfg, x, cache, int(pos))
    h = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], cfg, h)[:, 0], cache


def build_model(cfg: ModelConfig) -> Model:
    if cfg.is_encdec:
        raise NotImplementedError(
            "encoder-decoder models are not in the port yet (ROADMAP "
            "A11-rest.4)")
    return Model(
        cfg=cfg,
        init=functools.partial(_init_lm, cfg=cfg),
        prepare=functools.partial(_prepare, cfg=cfg),
        forward=functools.partial(_lm_forward, cfg=cfg),
        prefill=functools.partial(_lm_prefill, cfg=cfg),
        decode_step=functools.partial(_lm_decode, cfg=cfg),
        cache_shape=functools.partial(T.stack_cache, cfg),
    )
