"""Top-level models (port of ``repro.models.model``): the decoder-only LM
(the dense, MoE and MLA attention families, chameleon's early fusion, the
recurrent families: xLSTM's mLSTM/sLSTM stacks, recurrentgemma's RG-LRU
with local attention) and whisper's encoder-decoder.

``build_model(cfg)`` -> ``Model`` with the entry points:

  init(generator, device)                  -> params  (cfg.pdtype)
  prepare(params)                          -> params with matmul weights
                                              in cfg.cdtype, cast once
  forward(params, batch)                   -> (logits, aux)
  loss(params, batch)                      -> (total, metrics)   train
  prefill(params, batch, max_len, *, landmark_draws, generator,
          global_batch)                    -> (last_logits, cache)
  decode_step(params, cache, tokens, pos)  -> (logits, cache)
  cache_shape(batch, max_len, device)      -> zero cache

``batch`` is ``{"tokens": (B, S) int}``, and for early fusion also
``"patches"`` (B, n_patch, d_model): precomputed patch embeddings that
replace the leading n_patch positions in ``forward`` and ``prefill``.
``forward``'s aux is the sum of the MoE blocks' load-balance losses (0 for
a dense model).  A config with ``mtp`` gets the reference's ``"mtp"``
sub-tree at ``init`` (so the trees match); serving never reads it, the
loss does (deepseek's multi-token prediction of token t + 2).

``loss`` takes a batch with ``"labels"`` (B, S) beside the inputs: the
mean cross-entropy over the labels ≥ 0 (f32 logsumexp), plus
``MOE_AUX_WEIGHT`` · aux and ``MTP_WEIGHT`` · the MTP loss where the config
has them; ``metrics`` has the reference's keys: ``ce``, ``aux`` (LM),
``mtp`` (with ``cfg.mtp``) and ``loss``.  Training runs on the unprepared
params (f32 weights cast per call, as the reference does).

The encoder-decoder (``cfg.is_encdec``) takes ``"frames"`` (B, S_enc,
frontend_dim), precomputed frame embeddings (the stubbed conv frontend),
beside the decoder's ``"tokens"``.  Its params are the reference's tree
(``frontend_proj``, the ``encoder`` and ``decoder`` stacks, ``enc_norm``,
``xattn``: one {"xattn", "xnorm"} per decoder layer, ``embed``,
``final_norm``); its cache is ``{"self": {"k", "v"}, "enc_kv": (k, v)}``,
each stacked on a leading axis of ``n_dec_layers`` as the reference's
``_encdec_cache`` lays it out: the decoder's self-attention cache and the
cross-attention's encoder K/V, computed once at prefill.

On a mesh (``distributed.sharding.use_mesh`` with params laid out by
``sharding.mesh_view``; ``launch.steps`` drives it) ``loss`` takes this
rank's rows of the batch and returns this rank's share of the loss: the
shares of the data ranks add up to the global loss (the CE summed over
the rank's tokens over the global token count; the aux, a global value,
over the data ranks' count), and ``metrics`` holds the global values.  A
vocabulary split over ``model`` gives the CE by a distributed
log-sum-exp (``vocab_parallel_nll``): the logits are never gathered.

``loss`` reads the rows of the batch that ``sharding.batch_pspec`` gives
this rank (``launch.steps.local_rows``): a batch that the data axes do
not divide lies over ``data`` alone where ``data`` divides it, else whole
on every rank, as the reference lays it out.  The global token count is
summed over every data axis, so it counts a row once for each rank that
holds it, and the shares still add up to the global loss.

``prefill`` and ``decode_step`` run there too, on this rank's shards:
the params, the batch rows that ``sharding.batch_pspec`` gives it (a
batch that ``data`` does not divide is whole on every rank; ``prefill``
takes ``global_batch``, the rows of every rank) and the cache, laid out
by ``sharding.cache_shardings`` of the whole cache: ``prefill`` returns
this rank's shards carrying their specs (``sharding.mesh_view``), which
``decode_step`` reads.  The logits come back with their vocabulary
whole (``batch_pspec((B, V))``).  Every family runs on a mesh:
deepseek's multi-token prediction too (its ``proj`` a partial product
where ``model`` splits it, its block through ``block_full``'s mesh paths,
its NLL vocabulary-parallel), the recurrent mixers on their own mesh
paths with their states laid out by ``sharding.state_pspec``
(``models.recurrent``), and the encoder-decoder: the frontend projection
split by d_model and gathered, the encoder, the decoder and the
cross-attention over heads, ``enc_kv`` under ``cache_shardings`` (split
by sequence at 1,024 frames or more where the batch is not split, read
through a log-sum-exp merge at decode).  MLA under ``seq_parallel_attn``
too: its training and prefill split the query rows over ``model``
(``attention._mla_sp``).

Randomness is explicit: ``init`` draws from a ``torch.Generator``, and
``prefill`` takes the landmark layers' draws (``landmark_draws``, see
``transformer.stack_prefill``) or draws them from ``generator``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import generator_or_default, resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as T

#: parameter names of the matmul weights, cast by ``prepare``; the rest (norm
#: scales, and the MoE ``router``, which computes in f32) keep their dtype.
#: A recurrent mixer's weights go by its kind instead
#: (``recurrent.COMPUTE_WEIGHTS``): sLSTM's ``wo`` is an f32 gate weight.
MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "wi_gate", "wi_up", "embedding",
                  "unembed", "wq_a", "wq_b", "wkv_a", "wkv_b", "proj",
                  "frontend_proj")

#: profiler ranges of the encoder-decoder: the encoder stack, and every
#: cross-attention (prefill and decode), so a profile can tell their
#: flash-attention launches from the decoder's causal ones
ENCODE_RANGE = "encdec.encode"
CROSS_RANGE = "encdec.cross"

MOE_AUX_WEIGHT = 0.01
MTP_WEIGHT = 0.3

_F32 = torch.float32


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable
    prepare: Callable
    forward: Callable
    loss: Callable
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


def _cast(params, cfg: ModelConfig, names=MATMUL_WEIGHTS):
    """``params`` with every tensor named in ``names`` in the compute
    dtype, at any depth."""
    if isinstance(params, dict):
        return {k: (L.as_compute(v, cfg.cdtype) if k in names
                    and isinstance(v, torch.Tensor) else _cast(v, cfg, names))
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_cast(v, cfg, names) for v in params]
    return params


def _prepare_stack(stack: dict, cfg: ModelConfig) -> dict:
    """Each block by its kind: a recurrent mixer casts the weights its
    kind reads in the compute dtype, the rest of the block the matmul
    weights by name."""
    out = T._empty_like_layout(cfg)
    for section, r, i, kind in T.layer_slots(cfg):
        block = T._entry(stack, section, r, i)
        T._append(out, section, r, {
            k: (_cast(v, cfg, R.COMPUTE_WEIGHTS[kind])
                if k == "mixer" and kind in T.REC_KINDS else _cast(v, cfg))
            for k, v in block.items()})
    return out


def _prepare(params, cfg: ModelConfig):
    """The same params with every matmul weight in the compute dtype, cast
    once (the reference casts per call; the numbers are the same).  Norm
    scales keep their dtype: the norms compute in f32.  So do the weights
    a recurrent mixer reads in f32: RG-LRU's ``lam``, mLSTM's gate weights,
    every sLSTM weight but ``wo_proj``."""
    if isinstance(params, dict) and "stack" in params:
        return {k: (_prepare_stack(v, cfg) if k == "stack" else _cast(v, cfg))
                for k, v in params.items()}
    return _cast(params, cfg)


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


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over all positions; f32 logsumexp; labels < 0 are masked."""
    logits = logits.to(_F32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, torch.clamp(labels, min=0)[..., None])[
        ..., 0]
    mask = (labels >= 0).to(_F32)
    nll = (lse - ll) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)


class _VocabParallelNLL(torch.autograd.Function):
    """-log softmax(logits)[label] per row, the logits split over ``model``
    by vocabulary: the max and the sum of exponentials all-reduced, the
    target logit taken from the rank that holds it.  The backward is each
    rank's slice of softmax − one-hot; the loss is replicated over
    ``model``, so no collective runs there."""

    @staticmethod
    def forward(ctx, logits, labels, first, mesh):
        lg = logits.to(_F32)
        m = C.all_reduce(torch.amax(lg, dim=-1), "model", op="max",
                         mesh=mesh)
        e = torch.exp(lg - m[..., None])
        s = C.all_reduce(torch.sum(e, dim=-1), "model", mesh=mesh)
        local = labels - first
        mine = (local >= 0) & (local < lg.shape[-1])
        at = torch.where(mine, local, 0)
        tl = torch.gather(lg, -1, at[..., None])[..., 0] * mine.to(_F32)
        tl = C.all_reduce(tl, "model", mesh=mesh)
        ctx.save_for_backward(e.div_(s[..., None]), at, mine)
        ctx.dtype = logits.dtype
        return torch.log(s) + m - tl

    @staticmethod
    def backward(ctx, g):
        p, at, mine = ctx.saved_tensors
        grad = p * g[..., None]
        grad.scatter_add_(-1, at[..., None], (-g * mine.to(_F32))[..., None])
        return grad.to(ctx.dtype), None, None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       first: int) -> torch.Tensor:
    """Per-row NLL of vocabulary-split logits (this rank's entries
    ``first`` on) under the ambient mesh."""
    return _VocabParallelNLL.apply(logits, labels, first, shd.ambient_mesh())


def _labels(batch: dict, device) -> torch.Tensor:
    return torch.as_tensor(batch["labels"], dtype=torch.int64, device=device)


def _lm_hidden(params: dict, cfg: ModelConfig, batch: dict):
    x = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = T.stack_full(params["stack"], cfg, x, positions)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def _lm_forward(params: dict, batch: dict, *, cfg: ModelConfig):
    h, aux = _lm_hidden(params, cfg, batch)
    return _logits(params, cfg, h), aux


def _mtp_hidden(params: dict, cfg: ModelConfig, batch: dict,
                h: torch.Tensor) -> torch.Tensor:
    """deepseek MTP's hidden state for predicting t+2 from [norm(h_t);
    norm(emb(token_{t+1}))].  On a mesh h and the tokens are this rank's
    rows; a ``proj`` split over ``model`` (by its 2d rows) is a partial
    product summed over ``model``, and the block takes ``block_full``'s
    mesh paths."""
    mp, device = params["mtp"], h.device
    tok_next = torch.roll(_tokens(batch, device), -1, dims=1)
    e = L.embed(params["embed"], cfg, tok_next)
    z = torch.cat([L.rmsnorm(mp["norm_h"], h, cfg.norm_eps),
                   L.rmsnorm(mp["norm_e"], e, cfg.norm_eps)], dim=-1)
    proj = L.as_compute(mp["proj"], cfg.cdtype)
    if shd.split(mp, "proj", 0):
        first = shd.axis_index("model") * proj.shape[0]
        z = C.copy_to(z, "model")[..., first:first + proj.shape[0]]
        z = C.reduce_from(z @ proj, "model")
    else:
        z = z @ proj
    positions = torch.arange(z.shape[1], device=device)
    z, _ = T.block_full(mp["block"], cfg, "attn", z, positions)
    return L.rmsnorm(mp["final_norm"], z, cfg.norm_eps)


def _mtp_labels(batch: dict, device) -> torch.Tensor:
    labels2 = torch.roll(_labels(batch, device), -1, dims=1)
    labels2[:, -2:].fill_(-1)                                # no target
    return labels2


def _mtp_loss(params: dict, cfg: ModelConfig, batch: dict,
              h: torch.Tensor) -> torch.Tensor:
    """deepseek MTP: predict t+2 from [norm(h_t); norm(emb(token_{t+1}))]."""
    z = _mtp_hidden(params, cfg, batch, h)
    return softmax_xent(L.unembed(params["embed"], cfg, z),
                        _mtp_labels(batch, h.device))


def _mesh_nll(params: dict, cfg: ModelConfig, h: torch.Tensor,
              labels: torch.Tensor):
    """(this rank's share of the mean NLL over every data rank's labels
    ≥ 0, its global value) of the unembedding of h, vocabulary-parallel
    where the table is split."""
    logits = L.unembed(params["embed"], cfg, h)
    first, width = L.vocab_slice(params["embed"], cfg)
    if width != cfg.vocab_size:
        nll = vocab_parallel_nll(logits, labels, first)
    else:
        lg = logits.to(_F32)
        nll = torch.logsumexp(lg, dim=-1) - torch.gather(
            lg, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    del logits
    mask = (labels >= 0).to(_F32)
    dp = shd.data_axes(shd.ambient_mesh())
    count = C.all_reduce(torch.sum(mask), dp)
    share = torch.sum(nll * mask) / torch.clamp(count, min=1.0)
    return share, C.all_reduce(share.detach(), dp)


def _mesh_loss(params: dict, cfg: ModelConfig, batch: dict, h: torch.Tensor,
               aux: torch.Tensor):
    """This rank's share of the loss on a mesh, and the global metrics."""
    share, ce = _mesh_nll(params, cfg, h, _labels(batch, h.device))
    dp = shd.data_axes(shd.ambient_mesh())
    total = share + MOE_AUX_WEIGHT * aux / C.axes_size(dp)
    metrics = {"ce": ce, "aux": aux}
    loss = ce + MOE_AUX_WEIGHT * aux.detach()
    if cfg.mtp:
        share, mtp = _mesh_nll(params, cfg,
                               _mtp_hidden(params, cfg, batch, h),
                               _mtp_labels(batch, h.device))
        total = total + MTP_WEIGHT * share
        metrics["mtp"] = mtp
        loss = loss + MTP_WEIGHT * mtp
    metrics["loss"] = loss
    return total, metrics


def _lm_loss(params: dict, batch: dict, *, cfg: ModelConfig):
    h, aux = _lm_hidden(params, cfg, batch)
    if shd.mesh_active():
        return _mesh_loss(params, cfg, batch, h, aux)
    ce = softmax_xent(L.unembed(params["embed"], cfg, h),
                      _labels(batch, h.device))
    total = ce + MOE_AUX_WEIGHT * aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp:
        mtp = _mtp_loss(params, cfg, batch, h)
        total = total + MTP_WEIGHT * mtp
        metrics["mtp"] = mtp
    metrics["loss"] = total
    return total, metrics


def _logits(params: dict, cfg: ModelConfig, h: torch.Tensor
            ) -> torch.Tensor:
    """The unembedding of h, its vocabulary gathered over ``model`` where
    the table is split."""
    logits = L.unembed(params["embed"], cfg, h)
    if L.vocab_slice(params["embed"], cfg)[1] != cfg.vocab_size:
        logits = C.gather(logits, -1, "model")
    return logits


def _serving_rows(cfg: ModelConfig, local: int,
                  global_batch: Optional[int]) -> tuple:
    """(the global batch, the axes that split its rows) of a prefill on
    the ambient mesh, this rank holding ``local`` rows."""
    mesh = shd.ambient_mesh()
    if global_batch is None:
        if shd.data_size(mesh) > 1:
            raise ValueError("a prefill on a mesh with data ranks takes "
                             "global_batch (its rows are split over data "
                             "only when data divides it)")
        global_batch = local
    rows = shd.row_axes(global_batch, mesh)
    if local * shd.ambient_axis_size(rows) != global_batch:
        raise ValueError(f"{local} rows on this rank of a batch of "
                         f"{global_batch} split over {rows}")
    return global_batch, rows


def _cache_rows(cfg: ModelConfig, cache: dict) -> tuple:
    """The axes that split the batch rows of a cache of shards carrying
    their specs (``sharding.shard_cache``, a prefill's output): the batch
    entry of its first layer's leaves (of the encoder-decoder's self
    cache, whose batch is its second dimension)."""
    if cfg.is_encdec:
        specs, b = getattr(cache["self"], "specs", None), 1
    else:
        section, r, i, _ = T.layer_slots(cfg)[0]
        specs, b = getattr(T._entry(cache, section, r, i), "specs", None), 0
    if not specs:
        raise ValueError("a decode cache on a mesh carries its specs "
                         "(sharding.shard_cache, or a prefill's output)")
    return tuple(a for a in shd._entry_axes(next(iter(specs.values()))[b])
                 if shd.ambient_axis_size(a) > 1)


def _lm_prefill(params: dict, batch: dict, max_len: int, *,
                cfg: ModelConfig,
                landmark_draws: Optional[Dict[int, dict]] = None,
                generator: Optional[torch.Generator] = None,
                global_batch: Optional[int] = None):
    x = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    if not shd.mesh_active():
        x, caches = T.stack_prefill(params["stack"], cfg, x, positions,
                                    max_len, landmark_draws, generator)
    else:
        B, rows = _serving_rows(cfg, x.shape[0], global_batch)
        mesh = shd.ambient_mesh()
        specs = shd.cache_shardings(
            T.stack_cache(cfg, B, max_len, L.SPECS), mesh)
        with shd.use_rows(rows):
            x, caches = T.stack_prefill(params["stack"], cfg, x, positions,
                                        max_len, landmark_draws, generator,
                                        specs)
        caches = shd.mesh_view(caches, specs)
    h_last = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return _logits(params, cfg, h_last)[:, 0], caches


def _lm_decode(params: dict, cache: dict, tokens, pos: int, *,
               cfg: ModelConfig):
    x = L.embed(params["embed"], cfg, _tokens({"tokens": tokens},
                                              _device(params)))
    if not shd.mesh_active():
        x, cache = T.stack_decode(params["stack"], cfg, x, cache, int(pos))
    else:
        with shd.use_rows(_cache_rows(cfg, cache)):
            x, cache = T.stack_decode(params["stack"], cfg, x, cache,
                                      int(pos))
    h = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, h)[:, 0], cache


# ---------------------------------------------------------------------------
# whisper-style encoder-decoder
# ---------------------------------------------------------------------------

def _sinusoid(S: int, d: int, device=None) -> torch.Tensor:
    """(S, d) sinusoidal positions in f32: sin of pos / 10⁴^(2i/d) in the
    first half, cos in the second (the reference's)."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10_000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, n_layers=cfg.n_enc_layers,
                               layer_pattern=("attn",), first_k_dense=0)


def _dec_cfg(cfg: ModelConfig) -> ModelConfig:
    # the reference always stores the decoder stacked (``scan_layers``);
    # the converter reads that
    return dataclasses.replace(cfg, n_layers=cfg.n_dec_layers,
                               layer_pattern=("attn",), first_k_dense=0,
                               scan_layers=True)


def _scanned_slots(stack: dict, cfg: ModelConfig) -> list:
    """Each pattern slot's blocks across the superblocks of ``stack``, when
    the reference stacks them (``cfg.scan_layers``)."""
    reps = stack["scanned"]
    if not (cfg.scan_layers and reps):
        return []
    return [[rep[i] for rep in reps] for i in range(len(reps[0]))]


def stacked_layers(params: dict, cfg: ModelConfig) -> list:
    """The per-layer sub-trees of ``params`` that the reference holds
    stacked on a leading layer axis, one list for each stacked tree: each
    pattern slot's blocks across the superblocks under ``cfg.scan_layers``,
    and an encoder-decoder's decoder blocks and cross-attentions always
    (its ``init`` vmaps them).  ``optim.adafactor(stacks=...)`` reads it."""
    if not cfg.is_encdec:
        return _scanned_slots(params["stack"], cfg)
    return (_scanned_slots(params["encoder"], _enc_cfg(cfg))
            + _scanned_slots(params["decoder"], _dec_cfg(cfg))
            + [params["xattn"]])


def _init_encdec(generator: Optional[torch.Generator] = None, device=None,
                 *, cfg: ModelConfig) -> dict:
    device = resolve_device(device)
    g = generator_or_default(generator)
    pd = cfg.pdtype
    return {
        "frontend_proj": L.dense_init(g, (cfg.frontend_dim, cfg.d_model), pd,
                                      device=device),
        "encoder": T.init_stack(g, _enc_cfg(cfg), device),
        "enc_norm": L.init_rmsnorm(cfg.d_model, pd, device),
        "decoder": T.init_stack(g, _dec_cfg(cfg), device),
        "xattn": [{"xattn": A.init_attention(g, cfg, device, cross=True),
                   "xnorm": L.init_rmsnorm(cfg.d_model, pd, device)}
                  for _ in range(cfg.n_dec_layers)],
        "embed": L.init_embed(g, cfg, device),
        "final_norm": L.init_rmsnorm(cfg.d_model, pd, device),
    }


def _encode(params: dict, cfg: ModelConfig, frames) -> torch.Tensor:
    """frames (B, S_enc, frontend_dim) -> the encoder output (B, S_enc,
    d_model): the frontend projection, the sinusoid added, the
    bidirectional stack (each layer's q and k also rotated by RoPE, as the
    reference's), the final norm."""
    dt, device = cfg.cdtype, _device(params)
    frames = torch.as_tensor(frames, device=device)
    with torch.profiler.record_function(ENCODE_RANGE):
        x = frames.to(dt) @ L.as_compute(params["frontend_proj"], dt)
        if shd.split(params, "frontend_proj", 1):
            x = C.gather(x, -1, "model")
        S = x.shape[1]
        x = x + _sinusoid(S, cfg.d_model, device).to(dt)[None]
        positions = torch.arange(S, device=device)
        x, _ = T.stack_full(params["encoder"], _enc_cfg(cfg), x, positions,
                            causal=False)
        return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _dec_layers(params: dict):
    """(self-attention block, cross-attention params) per decoder layer;
    on a mesh the cross-attention's FSDP-split weights are gathered as
    its layer comes (``sharding.materialize``)."""
    return ((rep[0], shd.materialize(xp)) for rep, xp in zip(
        params["decoder"]["scanned"], params["xattn"]))


def _cross(xp: dict, cfg: ModelConfig, h: torch.Tensor, ek: torch.Tensor,
           ev: torch.Tensor, spec=None) -> torch.Tensor:
    """h + the cross-attention of norm(h) against the encoder K/V (a cache
    shard laid out by ``spec`` on a mesh)."""
    with torch.profiler.record_function(CROSS_RANGE):
        xnorm = L.rmsnorm(xp["xnorm"], h, cfg.norm_eps)
        return h + A.cross_attention(xp["xattn"], cfg, xnorm, ek, ev, spec)


def _dec_stack(params: dict, cfg: ModelConfig, x: torch.Tensor,
               enc_out: torch.Tensor, positions: torch.Tensor
               ) -> torch.Tensor:
    """The decoder: (causal self-attention block, cross-attention) pairs,
    each layer projecting its own encoder K/V."""
    dcfg = _dec_cfg(cfg)
    for sb, xp in _dec_layers(params):
        x, _ = T.block_full(sb, dcfg, "attn", x, positions)
        x = _cross(xp, cfg, x, *A.encoder_kv(xp["xattn"], cfg, enc_out))
    return x


def _encdec_hidden(params: dict, cfg: ModelConfig, batch: dict
                   ) -> torch.Tensor:
    enc_out = _encode(params, cfg, batch["frames"])
    x = L.embed(params["embed"], cfg, _tokens(batch, enc_out.device))
    positions = torch.arange(x.shape[1], device=x.device)
    x = _dec_stack(params, cfg, x, enc_out, positions)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def _encdec_forward(params: dict, batch: dict, *, cfg: ModelConfig):
    h = _encdec_hidden(params, cfg, batch)
    return (_logits(params, cfg, h),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _encdec_loss(params: dict, batch: dict, *, cfg: ModelConfig):
    """The mean CE over the labels ≥ 0; on a mesh this rank's share of it
    (``_mesh_nll``) and its global value."""
    h = _encdec_hidden(params, cfg, batch)
    if shd.mesh_active():
        share, ce = _mesh_nll(params, cfg, h, _labels(batch, h.device))
        return share, {"ce": ce, "loss": ce}
    ce = softmax_xent(L.unembed(params["embed"], cfg, h),
                      _labels(batch, h.device))
    return ce, {"ce": ce, "loss": ce}


def _encdec_prefill(params: dict, batch: dict, max_len: int, *,
                    cfg: ModelConfig,
                    landmark_draws: Optional[Dict[int, dict]] = None,
                    generator: Optional[torch.Generator] = None,
                    global_batch: Optional[int] = None):
    """Encode the frames; prime the decoder's self-attention cache with the
    prompt tokens; project each layer's cross-attention K/V once, into the
    cache.  Returns (the last position's logits, cache).  The decoder has
    no landmark layer, so ``landmark_draws`` and ``generator`` are unused.

    On a mesh the rows are this rank's (``global_batch`` the rows of
    every rank, as the LM's prefill takes them) and the cache is this
    rank's shards under ``sharding.cache_shardings`` of the whole cache,
    carrying their specs: the self cache as an attention layer lays its
    own out, the encoder K/V, computed by each rank for its heads, moved
    to a split by sequence in one all-to-all where the layout says so."""
    enc_out = _encode(params, cfg, batch["frames"])
    dcfg = _dec_cfg(cfg)
    x = L.embed(params["embed"], cfg, _tokens(batch, enc_out.device))
    positions = torch.arange(x.shape[1], device=x.device)
    S_enc, specs, on_rows = enc_out.shape[1], None, contextlib.nullcontext()
    if shd.mesh_active():
        B, axes = _serving_rows(cfg, x.shape[0], global_batch)
        mesh, on_rows = shd.ambient_mesh(), shd.use_rows(axes)
        whole = _encdec_cache(cfg, B, max_len, L.SPECS, enc_len=S_enc)
        specs = shd.cache_shardings(whole, mesh)
        cache = shd.map_with_path(lambda _, t: torch.zeros(
            t.shape, dtype=t.dtype, device=x.device),
            shd.shard_tree(whole, specs, mesh))
    else:
        cache = _encdec_cache(cfg, x.shape[0], max_len, x.device,
                              enc_len=S_enc)
    self_spec = None if specs is None else {
        n: _layer_spec(specs["self"][n]) for n in ("k", "v")}
    with on_rows:
        for i, (sb, xp) in enumerate(_dec_layers(params)):
            x, c = T.block_prefill(sb, dcfg, "attn", x, positions, max_len,
                                   spec=self_spec)
            cache["self"]["k"][i].copy_(c["k"])
            cache["self"]["v"][i].copy_(c["v"])
            del c
            ek, ev = A.encoder_kv(xp["xattn"], cfg, enc_out)
            x = _cross(xp, cfg, x, ek, ev)
            split = shd.split(xp["xattn"], "wk", 1)
            for t, dst, spec in zip((ek, ev), cache["enc_kv"], (
                    (None, None) if specs is None else specs["enc_kv"])):
                dst[i].copy_(t if spec is None else A._cache_layout(
                    t, _layer_spec(spec), split))
            del ek, ev
    h = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    logits = _logits(params, cfg, h)[:, 0]
    return logits, (cache if specs is None else shd.mesh_view(cache, specs))


def _layer_spec(spec) -> shd.Spec:
    """A per-layer spec of a stacked cache leaf's (its first entry, the
    decoder layers, dropped)."""
    return shd.Spec(spec[1:])


def _encdec_decode(params: dict, cache: dict, tokens, pos: int, *,
                   cfg: ModelConfig):
    """One decoder token: each layer's self-attention reads and updates
    its slice of the self cache in place (the full-cache decode read),
    then attends across to the cached encoder K/V.  On a mesh the cache
    is this rank's shards carrying their specs (a prefill's output): each
    layer reads its slices under them (``attention.attention_decode``,
    ``attention.cross_attention``)."""
    dcfg = _dec_cfg(cfg)
    x = L.embed(params["embed"], cfg, _tokens({"tokens": tokens},
                                              _device(params)))
    ek_all, ev_all = cache["enc_kv"]
    self_specs = getattr(cache["self"], "specs", None)
    enc_spec, on_rows = None, contextlib.nullcontext()
    if shd.mesh_active():
        on_rows = shd.use_rows(_cache_rows(cfg, cache))
        enc_spec = _layer_spec(cache["enc_kv"].specs[0])
    with on_rows:
        for i, (sb, xp) in enumerate(_dec_layers(params)):
            c = {"k": cache["self"]["k"][i], "v": cache["self"]["v"][i]}
            if self_specs:
                c = shd.MeshParams(c, {n: _layer_spec(self_specs[n])
                                       for n in c})
            x, _ = T.block_decode(sb, dcfg, "attn", x, c, int(pos))
            x = _cross(xp, cfg, x, ek_all[i], ev_all[i], enc_spec)
    h = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, h)[:, 0], cache


def _encdec_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
                  enc_len: int = 1500) -> dict:
    """The zero cache: the decoder's self-attention k/v (n_dec_layers, B,
    max_len, KV, D) and the encoder K/V (n_dec_layers, B, enc_len, KV, D),
    in the compute dtype."""
    if device != L.SPECS:
        device = resolve_device(device)
    kv, hd = cfg.n_kv_heads, cfg.head_dim

    def z(length):
        return L.filled((cfg.n_dec_layers, batch, length, kv, hd),
                        cfg.cdtype, device)

    return {"self": {"k": z(max_len), "v": z(max_len)},
            "enc_kv": (z(enc_len), z(enc_len))}


def build_model(cfg: ModelConfig) -> Model:
    if cfg.is_encdec:
        return Model(
            cfg=cfg,
            init=functools.partial(_init_encdec, cfg=cfg),
            prepare=functools.partial(_prepare, cfg=cfg),
            forward=functools.partial(_encdec_forward, cfg=cfg),
            loss=functools.partial(_encdec_loss, cfg=cfg),
            prefill=functools.partial(_encdec_prefill, cfg=cfg),
            decode_step=functools.partial(_encdec_decode, cfg=cfg),
            cache_shape=functools.partial(_encdec_cache, cfg),
        )
    return Model(
        cfg=cfg,
        init=functools.partial(_init_lm, cfg=cfg),
        prepare=functools.partial(_prepare, cfg=cfg),
        forward=functools.partial(_lm_forward, cfg=cfg),
        loss=functools.partial(_lm_loss, cfg=cfg),
        prefill=functools.partial(_lm_prefill, cfg=cfg),
        decode_step=functools.partial(_lm_decode, cfg=cfg),
        cache_shape=functools.partial(T.stack_cache, cfg),
    )
