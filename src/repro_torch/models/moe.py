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
n_shared · moe_d_ff, added unconditionally.  No custom kernel: the
reference computes the expert GEMMs, the sort and the scatter as XLA ops
outside any Pallas kernel.

On a mesh (``distributed.sharding.use_mesh``, params as ``MeshParams``):

- the gather path keeps the reference's global semantics (GSPMD runs its
  one program over the global batch): the capacity is that of every
  token of the data ranks, an expert's slots go to the tokens in global
  order (``_assign``'s ``offsets``: the assignments of the lower data
  ranks, one all-gather of E counts), and the aux is formed from the
  global means; the data ranks are those that split the batch rows
  (``sharding.batch_axes``: none when a serving batch is whole on every
  rank, as a decode of one sequence is).  Serving takes the same path
  at prefill and at decode (T = B: the capacity of the global B tokens),
  filling its buffer in place.  With the experts split over ``model``
  each rank computes
  its own experts' slots, with the FFN width split each rank its part of
  every expert; the partial combine is summed over ``model``;
- ``moe_impl="shard_map"`` is the reference's expert parallelism
  (``_moe_shard_map``) where the experts divide data × model
  (``_ep_axes_available``): each ``model`` rank routes the disjoint token
  slice ``rank·T_loc`` of its data slice, with its own aux (``pmean``ed
  over the EP group) and capacity max(8, ⌈int(cf·(T_loc·k)/E)⌉₈); one
  ``all_to_all`` carries the slots to the experts' ranks and one brings
  them back; the combine is this path's fixed order, and the slices are
  all-gathered over ``model``.  Its data slice is the reference's: the
  global tokens split over every data axis (its ``tok_spec``).  Where
  the rows are not split so (a batch that ``pod × data`` does not divide:
  ``sharding.batch_axes``), the rows are all-gathered and each rank takes
  its slice of the tokens, and the output is laid back by one all-gather
  over the data axes (``_tokens_over_data``); a token count the data axes
  do not divide keeps each rank's own rows.  Without the divisibility of
  the experts it is the gather path, as in the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd
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


def _route(params: dict, cfg: ModelConfig, xf: torch.Tensor,
           group_mean=None):
    """xf: (T, d) -> top-k weights (T, k) f32, expert ids (T, k) int64, and
    the Switch-style load-balance aux E · Σ_e frac_e · mean_prob_e.
    ``group_mean`` replaces the mean over the tokens (a mean over every
    data rank's tokens on a mesh)."""
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
    mean = group_mean or (lambda t: torch.mean(t, dim=0))
    frac = mean(hard) / cfg.moe_top_k
    aux = E * torch.sum(frac * mean(probs))
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


def _assign(cfg: ModelConfig, idx: torch.Tensor, C: int,
            offsets: Optional[torch.Tensor] = None):
    """The dispatch plan of the T·k assignments, in routing order (token t's
    j-th choice is entry t·k + j): its token, its buffer slot (E·C for a
    dropped assignment) and whether it is kept.  ``offsets`` (E,) counts
    each expert's assignments that come before these tokens (a mesh's
    lower data ranks)."""
    E, k = cfg.n_experts, cfg.moe_top_k
    eids = idx.reshape(-1)
    Tk = eids.shape[0]
    ar = torch.arange(Tk, device=idx.device)
    se, order = torch.sort(eids, stable=True)
    first = torch.searchsorted(se, se, side="left")
    pos_in_e = ar - first
    if offsets is not None:
        pos_in_e = pos_in_e + offsets[se]
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
                      w: torch.Tensor, idx: torch.Tensor,
                      C: Optional[int] = None,
                      offsets: Optional[torch.Tensor] = None,
                      first_expert: int = 0) -> torch.Tensor:
    """Sort-based capacity dispatch.  xf: (T, d) -> (T, d) in the compute
    dtype.  ``C`` and ``offsets`` default to these T tokens alone; banks of
    fewer than E experts (split over ``model``) hold experts
    ``first_expert`` on, and only their slots are computed."""
    T, d = xf.shape
    E, k = params["wi_gate"].shape[0], cfg.moe_top_k
    dt = cfg.cdtype
    C = capacity(cfg, T) if C is None else C
    tok, slot, keep = _assign(cfg, idx, C, offsets)
    if E != cfg.n_experts:                 # this rank's experts' slots
        lo = first_expert * C
        mine = (slot >= lo) & (slot < lo + E * C)
        keep = keep & mine
        slot = torch.where(mine, slot - lo, E * C)
    # every drop lands in row E·C, which no expert reads
    train = _tracks_grad(params, xf, w)
    if train:
        buf = torch.zeros((E * C + 1, d), dtype=dt,
                          device=xf.device).index_copy(0, slot,
                                                       xf[tok].to(dt))
    else:
        buf = torch.empty((E * C + 1, d), dtype=dt, device=xf.device)
        buf[:E * C].zero_()
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
        buf[E * C].zero_()                 # a dropped assignment adds 0
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
    if shd.mesh_active():
        out, aux = (_moe_shard_map(params, cfg, xf)
                    if cfg.moe_impl == "shard_map" and _ep_axes_available(cfg)
                    else _moe_gather_mesh(params, cfg, xf))
    else:
        w, idx, aux = _route(params, cfg, xf)
        out = _dispatch_compute(params, cfg, xf, w, idx)
    if cfg.n_shared_experts:
        out = out + L.mlp(params["shared"], cfg, xf)
    return out.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# on a mesh
# ---------------------------------------------------------------------------

def _data_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean over the tokens of every data rank (equal counts): the
    gradient of a rank's share flows back to every rank's tokens."""
    axes = shd.batch_axes()
    n = C.axes_size(axes)
    m = torch.mean(t, dim=0)
    return m if n == 1 else C.all_reduce_sum(m, axes) / n


def _moe_gather_mesh(params: dict, cfg: ModelConfig, xf: torch.Tensor):
    """The gather path on a mesh, with the reference's global semantics
    (the tokens of the ranks that split the batch rows: a serving batch
    that ``data`` does not divide is whole on every rank)."""
    axes = shd.batch_axes()
    n = C.axes_size(axes)
    w, idx, aux = _route(params, cfg, xf, group_mean=_data_mean)
    offsets = None
    if n > 1:
        # a bincount, which has no meta kernel (``launch.dryrun``)
        flat = idx.reshape(-1).long()
        counts = torch.zeros(cfg.n_experts, dtype=torch.int64,
                             device=idx.device).scatter_add_(
            0, flat, torch.ones_like(flat))
        every = C.all_gather(counts[None], 0, axes)          # (n, E)
        offsets = torch.sum(every[:shd.axis_index(axes)], dim=0)
    Cap = capacity(cfg, xf.shape[0] * n)
    by_expert = shd.split(params, "wi_gate", 0)
    tp = by_expert or shd.split(params, "wi_gate", 2)
    if tp:
        xf, w = C.copy_to(xf, "model"), C.copy_to(w, "model")
    first = (shd.axis_index("model") * params["wi_gate"].shape[0]
             if by_expert else 0)
    out = _dispatch_compute(params, cfg, xf, w, idx, Cap, offsets, first)
    return (C.reduce_from(out, "model") if tp else out), aux


def _ep_axes(cfg: ModelConfig):
    return ("data", "model")


def _ep_axes_available(cfg: ModelConfig) -> bool:
    n = 1
    for a in _ep_axes(cfg):
        n *= shd.ambient_axis_size(a)
    return n > 1 and cfg.n_experts % n == 0


def ep_capacity(cfg: ModelConfig, T_loc: int) -> int:
    """The expert-parallel capacity of T_loc tokens a rank: max(8, int(cf ·
    (T_loc·k) / E) rounded up to a multiple of 8), the reference's
    expression (T·k formed first)."""
    Tk = T_loc * cfg.moe_top_k
    return max(8, -(-int(cfg.capacity_factor * Tk / cfg.n_experts) // 8) * 8)


def _tokens_over_data(xf: torch.Tensor):
    """(this rank's slice of the global tokens over the data axes, a
    function taking the path's output on that slice back to this rank's
    rows) where the rows are split otherwise (``sharding.batch_axes``) and
    the data axes divide the token count; (xf, None) elsewhere.  Each
    all-gather's backward sums the ranks' gradients back
    (``collectives.all_gather_sum``)."""
    mesh = shd.ambient_mesh()
    dp, rows = (tuple(a for a in axes if shd.ambient_axis_size(a) > 1)
                for axes in (shd.data_axes(mesh), shd.batch_axes()))
    n_rows = shd.ambient_axis_size(rows)
    T = xf.shape[0] * n_rows
    if rows == dp or T % shd.ambient_axis_size(dp):
        return xf, None
    whole = C.all_gather_sum(xf, 0, rows) if rows else xf
    first, n = shd.local_range((dp,), 0, T, mesh)

    def back(out: torch.Tensor) -> torch.Tensor:
        out = C.all_gather_sum(out, 0, dp)
        mine = shd.local_range((rows,), 0, T, mesh) if rows else (0, T)
        return out.narrow(0, *mine)
    return whole.narrow(0, first, n), back


def _moe_shard_map(params: dict, cfg: ModelConfig, xf: torch.Tensor):
    """Expert parallelism over ('data', 'model') (the reference's
    ``_moe_shard_map``, step for step): xf is this rank's rows' tokens,
    replicated over ``model``, taken to the reference's data slice first
    (``_tokens_over_data``)."""
    xf, back = _tokens_over_data(xf)
    out, aux = _expert_parallel(params, cfg, xf)
    return (out if back is None else back(out)), aux


def _expert_parallel(params: dict, cfg: ModelConfig, xf: torch.Tensor):
    """``_moe_shard_map``'s body on this data slice's tokens xf."""
    axes = _ep_axes(cfg)
    tp = shd.ambient_axis_size("model")
    n_ep = shd.ambient_axis_size(axes)
    T_rep, d = xf.shape
    if T_rep % tp:
        raise ValueError(f"expert parallelism: {T_rep} tokens a data rank "
                         f"do not split over model = {tp}")
    T_loc = T_rep // tp
    xs = C.scatter(xf, 0, "model")                 # this rank's token slice
    router = C.copy_to(params["router"], "model")
    w, idx, aux = _route({"router": router}, cfg, xs)
    dp = shd.data_axes(shd.ambient_mesh())
    aux = C.reduce_from(C.all_reduce_sum(aux, dp), "model") / (
        C.axes_size(dp) * tp)                      # pmean over the group
    E, k, dt = cfg.n_experts, cfg.moe_top_k, cfg.cdtype
    E_loc = E // n_ep
    Cap = ep_capacity(cfg, T_loc)
    tok, slot, keep = _assign(cfg, idx, Cap)
    sbuf = torch.zeros((E * Cap + 1, d), dtype=dt,
                       device=xf.device).index_copy(0, slot, xs[tok].to(dt))
    sbuf = sbuf[:E * Cap].reshape(n_ep, E_loc * Cap, d)
    rbuf = C.all_to_all(sbuf, axes)
    rb = rbuf.reshape(n_ep, E_loc, Cap, d).transpose(0, 1) \
        .reshape(E_loc, n_ep * Cap, d)
    gate = F.silu(torch.bmm(rb, as_compute(params["wi_gate"], dt)))
    up = torch.bmm(rb, as_compute(params["wi_up"], dt))
    ob = torch.bmm(gate * up, as_compute(params["wo"], dt))
    del rb, gate, up
    ob = ob.reshape(E_loc, n_ep, Cap, d).transpose(0, 1) \
        .reshape(n_ep, E_loc * Cap, d)
    obuf = C.all_to_all(ob, axes)
    flat = torch.cat([obuf.reshape(E * Cap, d), obuf.new_zeros((1, d))])
    wk = (w.reshape(-1) * keep.to(_F32)).to(dt)
    vals = (flat[slot] * wk[:, None]).view(T_loc, k, d)
    out = vals[:, 0]
    for j in range(1, k):                  # a fixed order: bit-repeatable
        out = out + vals[:, j]
    return C.gather(out, 0, "model"), aux
