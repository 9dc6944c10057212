"""The decoder-only LM (port of ``repro.models.model``, dense attention
family; no loss, MTP or encoder-decoder yet — ROADMAP A11).

``build_model(cfg)`` -> ``Model`` with the serving entry points:

  init(generator, device)                  -> params  (cfg.pdtype)
  prepare(params)                          -> params with matmul weights
                                              in cfg.cdtype, cast once
  forward(params, batch)                   -> (logits, aux)
  prefill(params, batch, max_len, *, landmark_draws, generator)
                                           -> (last_logits, cache)
  decode_step(params, cache, tokens, pos)  -> (logits, cache)
  cache_shape(batch, max_len, device)      -> zero cache

``batch`` is ``{"tokens": (B, S) int}``.  Randomness is explicit: ``init``
draws from a ``torch.Generator``, and ``prefill`` takes the landmark layers'
draws (``landmark_draws``, see ``transformer.stack_prefill``) or draws them
from ``generator``.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import generator_or_default, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

#: parameter names of the matmul weights (the rest are norm scales)
MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "wi_gate", "wi_up", "embedding",
                  "unembed")


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
    return {"embed": L.init_embed(g, cfg, device),
            "stack": T.init_stack(g, cfg, device),
            "final_norm": L.init_rmsnorm(cfg.d_model, cfg.pdtype, device)}


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


def _lm_forward(params: dict, batch: dict, *, cfg: ModelConfig):
    tokens = _tokens(batch, _device(params))
    x = L.embed(params["embed"], cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    x = T.stack_full(params["stack"], cfg, x, positions)
    h = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.unembed(params["embed"], cfg, h), aux


def _lm_prefill(params: dict, batch: dict, max_len: int, *,
                cfg: ModelConfig,
                landmark_draws: Optional[Dict[int, dict]] = None,
                generator: Optional[torch.Generator] = None):
    tokens = _tokens(batch, _device(params))
    x = L.embed(params["embed"], cfg, tokens)
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
            "encoder-decoder models are not in the port yet (ROADMAP A11)")
    if cfg.mtp:
        raise NotImplementedError(
            "multi-token prediction is not in the port yet (ROADMAP A11)")
    return Model(
        cfg=cfg,
        init=functools.partial(_init_lm, cfg=cfg),
        prepare=functools.partial(_prepare, cfg=cfg),
        forward=functools.partial(_lm_forward, cfg=cfg),
        prefill=functools.partial(_lm_prefill, cfg=cfg),
        decode_step=functools.partial(_lm_decode, cfg=cfg),
        cache_shape=functools.partial(T.stack_cache, cfg),
    )
