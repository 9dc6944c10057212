"""Shared layers: norms, embeddings, RoPE, MLP variants (port of
``repro.models.layers``).

Plain functions on tensors with a params dict, as the reference's pytree:
``init_*`` returns the dict, the apply functions take (params, ..., x).
Parameter names are the reference's, so ``convert.model_params_from_reference``
maps its params one to one.

Weights are stored in ``cfg.pdtype`` and used in ``cfg.cdtype``: every
matmul weight goes through ``as_compute`` (a no-op for a weight already held
in the compute dtype, see ``Model.prepare`` in ``models.model``), norm
scales stay in f32 arithmetic.

On a mesh (``distributed.sharding.use_mesh`` and a ``MeshParams`` view of
the params) the vocabulary and the MLP width may be split over ``model``:
``embed`` looks up the rows it holds and sums the ranks' rows,
``unembed`` gives this rank's slice of the vocabulary (``vocab_slice``),
and ``mlp`` multiplies by its column and row slices and sums the partial
outputs (``distributed.collectives``).  Off a mesh every function is the
single-device code.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, TensorSpec
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd

_F32 = torch.float32


def as_compute(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``w`` in the compute dtype; no copy when it already is."""
    return w if w.dtype == dt else w.to(dt)


#: the ``device`` that asks a cache or state builder (``Model.cache_shape``,
#: ``transformer.stack_cache``) for its leaves' ``TensorSpec`` (shape and
#: dtype) alone: nothing is made where only the layout is read
#: (``sharding.cache_shardings``)
SPECS = "specs"


def filled(shape, dtype, device, value: float = 0.0):
    """A leaf of a fresh cache or state: ``value`` everywhere (zeros by
    default), or its ``TensorSpec`` on ``SPECS``."""
    if isinstance(device, str) and device == SPECS:
        return TensorSpec(tuple(shape), dtype)
    if value == 0.0:
        return torch.zeros(shape, dtype=dtype, device=device)
    return torch.full(shape, value, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, shape, dtype,
               scale: Optional[float] = None, device=None) -> torch.Tensor:
    """Truncated-normal (±3σ) fan-in init, drawn on the generator's device
    and moved to ``device``.  On the ``meta`` device nothing is drawn: the
    tensor has the shape and dtype alone (``launch.steps.build_cell``'s
    abstract params, 671B of them for deepseek-v3)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(tuple(shape), dtype=_F32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    w.mul_(std)
    return w.to(device=device if device is not None else w.device,
                dtype=dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device=None) -> dict:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """gemma-style: x / rms(x) · (1 + scale), in f32, back in x's dtype."""
    x32 = x.to(_F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].to(_F32))).to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def init_embed(generator: torch.Generator, cfg: ModelConfig,
               device=None) -> dict:
    # tied embeddings double as the unembed: std d^-1/2 keeps init-time
    # logits O(1) (scale_embed restores O(1) input activations)
    emb_std = cfg.d_model ** -0.5 if cfg.tie_embeddings else 1.0
    p = {"embedding": dense_init(generator, (cfg.vocab_size, cfg.d_model),
                                 cfg.pdtype, scale=emb_std, device=device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                  cfg.pdtype, device=device)
    return p


def embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor
          ) -> torch.Tensor:
    """Rows of the table in the compute dtype.  The rows are taken before
    the cast (the same numbers as casting the table first, without a
    vocab × d_model copy per call); ``scale_embed`` multiplies by √d_model
    rounded to the compute dtype, as the reference does."""
    dt = cfg.cdtype
    if shd.split(params, "embedding", 0):
        # this rank's rows of the vocabulary; the others' tokens give 0
        table = params["embedding"]
        local = tokens - shd.axis_index("model") * table.shape[0]
        mine = (local >= 0) & (local < table.shape[0])
        x = as_compute(table[torch.where(mine, local, 0)], dt) \
            * mine[..., None].to(dt)
        x = C.reduce_from(x, "model")
    else:
        x = as_compute(params["embedding"][tokens], dt)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=x.device)
    return x


def vocab_slice(params: dict, cfg: ModelConfig):
    """(first entry, width) of the vocabulary slice ``unembed`` gives on
    this rank; the whole vocabulary off a mesh."""
    key, dim = ("embedding", 0) if cfg.tie_embeddings else ("unembed", 1)
    if not shd.split(params, key, dim):
        return 0, cfg.vocab_size
    width = params[key].shape[dim]
    return shd.axis_index("model") * width, width


def unembed(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits over the vocabulary, or over this rank's slice of it
    (``vocab_slice``) where the table is split over ``model``."""
    dt = cfg.cdtype
    if vocab_slice(params, cfg)[1] != cfg.vocab_size:
        x = C.copy_to(x, "model")
    if cfg.tie_embeddings:
        logits = x @ as_compute(params["embedding"], dt).T
    else:
        logits = x @ as_compute(params["unembed"], dt)
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    return logits


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=_F32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, D) with positions (S,) or (..., S).  Rotates halves
    (split, not interleave), in f32; returns x's dtype."""
    D = x.shape[-1]
    freqs = rope_frequencies(D, theta, x.device)               # (D/2,)
    ang = positions[..., :, None].to(_F32) * freqs             # (..., S, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(_F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(generator: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None, device=None) -> dict:
    d = cfg.d_model
    ff = cfg.d_ff if d_ff is None else d_ff

    def w(shape):
        return dense_init(generator, shape, cfg.pdtype, device=device)

    if cfg.mlp_variant in ("swiglu", "geglu"):
        return {"wi_gate": w((d, ff)), "wi_up": w((d, ff)), "wo": w((ff, d))}
    return {"wi_up": w((d, ff)), "wo": w((ff, d))}


def mlp(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The FFN; with its width split over ``model`` each rank multiplies by
    its columns of ``wi_*`` and rows of ``wo``, and the partial outputs
    are summed."""
    tp = shd.split(params, "wi_up", 1)
    if tp:
        x = C.copy_to(x, "model")
    dt = cfg.cdtype
    up = x @ as_compute(params["wi_up"], dt)
    if cfg.mlp_variant == "swiglu":
        h = F.silu(x @ as_compute(params["wi_gate"], dt)) * up
    elif cfg.mlp_variant == "geglu":
        h = F.gelu(x @ as_compute(params["wi_gate"], dt),
                   approximate="tanh") * up
    elif cfg.mlp_variant == "relu2":
        h = torch.square(F.relu(up))
    elif cfg.mlp_variant == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(cfg.mlp_variant)
    out = h @ as_compute(params["wo"], dt)
    return C.reduce_from(out, "model") if tp else out
