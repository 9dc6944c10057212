"""Recurrent mixers: RG-LRU (recurrentgemma), mLSTM and sLSTM (xLSTM) (port
of ``repro.models.recurrent``).

Each mixer has the reference's entry points, with its names:

- ``init_*(generator, cfg, device)``         parameters
- ``*_full(params, cfg, x)``                 a full sequence -> y
- ``init_*_state(cfg, batch, device)``       zero decode state
- ``*_decode(params, cfg, x, state)``        one token; updates ``state`` in
                                             place and returns (y, state)

and one more, ``*_prefill(params, cfg, x) -> (y, state)``: the full pass and
the decode state after its last token.  The reference rebuilds that state by
a per-token decode scan over the prompt (``transformer._rec_prefill_state``,
ported as the oracle); here it comes out of the full pass, the same function
of the input: RG-LRU's last h and last K − 1 pre-conv inputs, mLSTM's carry
at the last chunk (its m recursion b_t + max(m_0, max_j g_j) equals the
decode's max(lf_t + m_{t−1}, li_t)), sLSTM's last step.  Only the rounding
differs.

The numerics follow the reference: matmul weights in the compute dtype
(``COMPUTE_WEIGHTS``, cast once by ``Model.prepare``), the gates, the
recurrences and the states in f32; RG-LRU's ``lam``, mLSTM's ``wi``, ``wf``
and ``bf`` are f32 parameters, and sLSTM reads its input and recurrent
weights in f32 (its ``wo`` is the output *gate's* input weight, not an
output projection: that one is ``wo_proj``).

The recurrences on the card:

- RG-LRU: the linear recurrence h_t = a_t·h_{t−1} + b_t (a_t = exp(log_a_t))
  as a log-depth doubling scan in torch ops (``linear_scan``: at offset
  d = 1, 2, 4, … every position folds in the one d back), in time chunks of
  ``SCAN_CHUNK`` tokens whose carry enters as exp(Σ log_a)·h; the reference
  uses ``jax.lax.associative_scan``, which rounds in another order.
- mLSTM: the reference's stabilized chunkwise form, one chunk of
  ``mlstm_chunk`` tokens after another.
- sLSTM: sequential in S, one step per token: the four gates' recurrent
  products are one ``baddbmm`` onto the input projections (made for all
  tokens at once), then the step's elementwise work.  On the card the
  loop's launches are captured once, ``SLSTM_GRAPH_STEPS`` steps in a CUDA
  graph, and replayed block after block (the same kernels on the same
  values); a fused scan kernel is later work.

Training: when autograd records a call (grad mode on and the input or a
weight requires grad), the RG-LRU scan goes through ``LinearScan`` (the
doubling scan forward, its adjoint scan backward) and the sLSTM loop runs
out of place and never from a CUDA graph (``_slstm_loop_grad``); the
mLSTM's chunk loop differentiates as it is.  Serving, grad mode on or
off, keeps the in-place forms and their bits.

On a mesh (``distributed.sharding.use_mesh``, params as ``MeshParams``)
each mixer reads its weights as the reference's rules lay them out
(``_leaf``: whole, or the rank's part of one dimension; ``_matmul``: a
weight split by rows as partial sums) and keeps its decode state as
``sharding.state_pspec`` lays it out, the rule ``cache_shardings`` gives
those leaves.  No collective runs inside a time loop: the RG-LRU runs its
part of the width (its state's split), the mLSTM and the sLSTM their
heads where ``model`` divides them; the exchanges come before and after
the loops, and at decode once a layer a token.  A prefill's state moves
to its layout once (``_relayout``).

The reference has no Pallas kernel for any of this; these are torch ops.
The recurrences run inside ``torch.profiler.record_function`` ranges
(``SCAN_RANGE``, ``SLSTM_RANGE``) so a profile can class their kernels.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models.attention import _out_proj, _proj
from repro_torch.models.layers import as_compute

_F32 = torch.float32
_RGLRU_C = 8.0
#: time chunk of the RG-LRU scan: bounds its f32 temporaries (a few
#: (B, SCAN_CHUNK, w) tensors) at long contexts
SCAN_CHUNK = 32_768
#: steps of the sLSTM loop a CUDA graph holds on the card
SLSTM_GRAPH_STEPS = 64
#: the profiler ranges around the recurrences
SCAN_RANGE = "recurrent.scan"
SLSTM_RANGE = "recurrent.slstm_steps"

#: per mixer kind, the weights read in the compute dtype (cast once by
#: ``Model.prepare``); every other leaf keeps its dtype
COMPUTE_WEIGHTS = {
    "rglru": ("w_gate", "w_x", "conv_k", "w_a", "w_i", "w_out"),
    "mlstm": ("wq", "wk", "wv", "wog", "wo"),
    "slstm": ("wo_proj",),
}
_GATES = ("z", "i", "f", "o")


# ===========================================================================
# reading weights on a mesh
# ===========================================================================

def _leaf(params: dict, key: str, dim: Optional[int] = None) -> torch.Tensor:
    """``params[key]`` whole, or (``dim``) with this rank's part of
    dimension ``dim`` over ``model``, whatever split the weight has: a
    dimension split elsewhere is all-gathered first.  The gradient comes
    back to the weight's own layout (a part scattered from a whole weight
    all-gathers its gradient; a gathered weight takes its part).  On one
    device ``params[key]``."""
    t = params[key]
    have = shd.split_dim(params, key)
    if have == dim:
        return t
    if have is not None:
        t = C.gather(t, have, "model")
    return t if dim is None else C.scatter(t, dim, "model")


def _matmul(params: dict, key: str, x: torch.Tensor, dt, x_part: bool,
            out_part: bool) -> torch.Tensor:
    """x @ ``params[key]`` (n, ...) flattened to 2-D, for x that holds its
    whole last dimension or (``x_part``) this rank's part of it over
    ``model``; the product whole or (``out_part``) this rank's part of
    its last dimension.  A weight split by rows gives partial sums,
    summed over ``model`` (all-reduce, or reduce-scatter to the part);
    any other weight is read whole.  On one device x @ w."""
    if shd.split(params, key, 0):
        w = as_compute(params[key], dt)
        w = w.reshape(w.shape[0], -1)
        if not x_part:
            x = C.scatter(x, -1, "model")
        y = x @ w
        return C.scatter_sum(y, -1, "model") if out_part \
            else C.reduce_from(y, "model")
    w = as_compute(_leaf(params, key), dt)
    w = w.reshape(w.shape[0], -1)
    if x_part:
        x = C.gather(x, -1, "model")
    y = x @ w
    return C.scatter(y, -1, "model") if out_part else y


def _state_dim(shape) -> Optional[int]:
    """The dimension of a recurrent state leaf of ``shape`` that ``model``
    splits on the ambient mesh (``sharding.state_pspec``), or None."""
    if not shd.mesh_active():
        return None
    d = shd._model_dim(shd.state_pspec(tuple(shape), shd.ambient_mesh()))
    return None if d < 0 else d


def _relayout(t: torch.Tensor, have: Optional[int],
              want: Optional[int]) -> torch.Tensor:
    """A state computed split over ``model`` on dimension ``have`` (None:
    whole) laid out split on ``want``: a part taken, an all-gather, or one
    all-to-all (``collectives.move_split``).  Forward only (serving)."""
    if have == want:
        return t
    if have is None:
        n = t.shape[want] // shd.ambient_axis_size("model")
        return t.narrow(want, shd.axis_index("model") * n, n).contiguous()
    if want is None:
        return C.all_gather(t, have, "model")
    return C.move_split(t, have, want, "model").contiguous()


# ===========================================================================
# RG-LRU block (Griffin recurrent block: gate branch ⊙ (conv -> RG-LRU))
# ===========================================================================

def init_rglru(generator: torch.Generator, cfg: ModelConfig,
               device=None) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    pd = cfg.pdtype

    def dense(shape, scale=None):
        return L.dense_init(generator, shape, pd, scale=scale, device=device)

    p = {"w_gate": dense((d, w)), "w_x": dense((d, w)),
         "conv_k": dense((cfg.rglru_conv_width, w),
                         cfg.rglru_conv_width ** -0.5),
         "w_a": dense((w, w)), "w_i": dense((w, w))}
    # Λ so that a = exp(-c softplus Λ) spans ~(0.9, 0.999)
    u = torch.rand((w,), dtype=_F32, device=generator.device,
                   generator=generator) * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / _RGLRU_C))   # softplus^-1
    p["lam"] = lam.to(device=device if device is not None else lam.device)
    p["w_out"] = dense((w, d))
    return p


def _causal_conv_full(x: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, w), kern: (K, w); each tap's
    product and sum in x's dtype, as the reference."""
    K, S = kern.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for j in range(K):
        out = out + xp[:, j:j + S] * kern[j]
    return out


def _w_part(cfg: ModelConfig) -> bool:
    """Does each rank run its part of the RG-LRU's width on the ambient
    mesh?  Where ``model`` splits the width of its state
    (``sharding.state_pspec``)."""
    return _state_dim((1, cfg.lru_width or cfg.d_model)) == 1


def _rglru_gates(params: dict, cfg: ModelConfig, u: torch.Tensor,
                 part: bool = False):
    """u: (..., w) post-conv input -> (log_a, b) of the recurrence, f32;
    with ``part``, u and the outputs are this rank's part of the width."""
    dt = cfg.cdtype
    r = torch.sigmoid(_matmul(params, "w_a", u, dt, part, part)).to(_F32)
    i = torch.sigmoid(_matmul(params, "w_i", u, dt, part, part)).to(_F32)
    lam = _leaf(params, "lam", 0 if part else None)
    log_a = -_RGLRU_C * F.softplus(lam) * r
    del r
    a2 = torch.exp(2.0 * log_a)
    b = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * u.to(_F32))
    return log_a, b


def _doubling_scan(log_a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = exp(log_a_t)·h_{t−1} + b_t along axis 1, from h0 (zeros when
    None): a doubling scan, ceil(log2 S) levels of whole-tensor ops.  At
    offset d every position t ≥ d folds in (A, h) at t − d, where A is the
    sum of log_a over the positions h covers; after the last level A is the
    inclusive prefix sum, so h0 enters as exp(A_t)·h0.  It writes its two
    working tensors in place, so autograd cannot record it: ``LinearScan``
    gives it a gradient."""
    A, h = log_a.clone(), b.clone()
    S = h.shape[1]
    d = 1
    while d < S:
        h[:, d:] = torch.addcmul(h[:, d:], torch.exp(A[:, d:]), h[:, :-d])
        A[:, d:] = A[:, d:] + A[:, :-d]
        d *= 2
    if h0 is not None:
        h = torch.addcmul(h, torch.exp(A), h0[:, None])
    return h


class LinearScan(torch.autograd.Function):
    """The doubling scan with its adjoint as the backward.  With
    g_t = ∂L/∂(h_t) through the whole recurrence,

        g_t = dh_t + a_{t+1}·g_{t+1}      (a linear scan over reversed t)
        ∂L/∂b_t = g_t,   ∂L/∂log_a_t = g_t·a_t·h_{t−1},   ∂L/∂h0 = a_0·g_0

    (h_{−1} = h0, or 0).  The backward runs that reversed recurrence
    through ``_doubling_scan`` too.  It saves log_a, h and h0: O(S·w),
    where autograd of an out-of-place doubling scan keeps every level."""

    @staticmethod
    def forward(ctx, log_a, b, h0):
        h = _doubling_scan(log_a, b, h0)
        ctx.save_for_backward(log_a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        log_a, h, h0 = ctx.saved_tensors
        # reversed time: step k folds in a_{S−k}, so
        # log a' = (0, log_a_{S−1}, …, log_a_1)
        rev_log_a = F.pad(torch.flip(log_a[:, 1:], (1,)), (0, 0, 1, 0))
        g = torch.flip(_doubling_scan(rev_log_a, torch.flip(dh, (1,))), (1,))
        del rev_log_a
        a = torch.exp(log_a)
        h_prev = torch.cat([torch.zeros_like(h[:, :1]) if h0 is None
                            else h0[:, None], h[:, :-1]], dim=1)
        d_log_a = g * a * h_prev
        d_h0 = a[:, 0] * g[:, 0] if h0 is not None else None
        return d_log_a, g, d_h0


def _records(x: torch.Tensor, *tensors) -> bool:
    """Whether autograd records a call on ``x`` and ``tensors`` (weights,
    None skipped): grad mode is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x,) + tensors)


def linear_scan(log_a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = exp(log_a_t)·h_{t−1} + b_t along axis 1, from h0 (zeros when
    None): ``_doubling_scan``, through ``LinearScan`` when autograd records
    the call; otherwise (serving) the scan alone, the same bits."""
    if _records(log_a, b, h0):
        return LinearScan.apply(log_a, b, h0)
    return _doubling_scan(log_a, b, h0)


def rglru_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, dict]:
    """(y, state): the full pass and the state after its last token — the
    scan's last h, and the last K − 1 pre-conv inputs (zeros before the
    first token when S < K − 1).

    On a mesh whose ``model`` splits the width of the state (``_w_part``)
    each rank runs its part W_r of the width: the products of x (whole)
    by ``w_x`` and ``w_gate`` and of u (its part) by ``w_a`` and ``w_i``
    are reduce-scattered to W_r where the weights are split by rows (the
    reference's rules split all five by their first dimension), the conv
    and the scan run on W_r alone with ``conv_k`` and ``lam`` read there,
    and (h·gate)[W_r] @ ``w_out``[W_r] is summed over ``model``.  The
    state is W_r's."""
    dt = cfg.cdtype
    B, S, _ = x.shape
    part = _w_part(cfg)
    u_in = _matmul(params, "w_x", x, dt, False, part)        # pre-conv
    u = _causal_conv_full(u_in, as_compute(
        _leaf(params, "conv_k", 1 if part else None), dt))
    K = cfg.rglru_conv_width
    conv = (F.pad(u_in, (0, 0, max(K - 1 - S, 0), 0))[:, -(K - 1):]
            if K > 1 else u_in[:, :0]).contiguous()
    del u_in
    hb = torch.empty_like(u)
    h_last = None
    with torch.profiler.record_function(SCAN_RANGE):
        for s0 in range(0, S, SCAN_CHUNK):
            log_a, b = _rglru_gates(params, cfg, u[:, s0:s0 + SCAN_CHUNK],
                                    part)
            h = linear_scan(log_a, b, h_last)
            del log_a, b
            h_last = h[:, -1].clone()
            hb[:, s0:s0 + SCAN_CHUNK] = h.to(dt)
            del h
    del u
    gate = F.gelu(_matmul(params, "w_gate", x, dt, False, part),
                  approximate="tanh")
    y = _matmul(params, "w_out", hb * gate, dt, part, False)
    return y, {"h": h_last, "conv": conv}


def rglru_full(params: dict, cfg: ModelConfig, x: torch.Tensor
               ) -> torch.Tensor:
    return rglru_prefill(params, cfg, x)[0]


def init_rglru_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {"h": L.filled((batch, w), _F32, device),
            "conv": L.filled((batch, cfg.rglru_conv_width - 1, w),
                             cfg.cdtype, device)}


def rglru_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: dict) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, d).  On a mesh as ``rglru_prefill``: the state is this
    rank's part of the width, and the token's products move as the full
    pass's do (four reduce-scatters and one all-reduce a layer)."""
    dt = cfg.cdtype
    part = _w_part(cfg)
    xt = x[:, 0]
    gate = F.gelu(_matmul(params, "w_gate", xt, dt, False, part),
                  approximate="tanh")
    u_new = _matmul(params, "w_x", xt, dt, False, part)       # (B, w)
    hist = torch.cat([state["conv"], u_new[:, None]], dim=1)  # (B, K, w)
    u = torch.einsum("bkw,kw->bw", hist, as_compute(
        _leaf(params, "conv_k", 1 if part else None), dt))
    log_a, b = _rglru_gates(params, cfg, u, part)
    h = torch.exp(log_a) * state["h"] + b
    y = _matmul(params, "w_out", h.to(dt) * gate, dt, part, False)
    state["h"], state["conv"] = h, hist[:, 1:]
    return y[:, None], state


# ===========================================================================
# mLSTM (matrix memory, chunkwise-stabilized)
# ===========================================================================

def init_mlstm(generator: torch.Generator, cfg: ModelConfig,
               device=None) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim

    def dense(shape, dtype=cfg.pdtype):
        return L.dense_init(generator, shape, dtype, device=device)

    return {"wq": dense((d, h, hd)), "wk": dense((d, h, hd)),
            "wv": dense((d, h, hd)), "wi": dense((d, h), _F32),
            "wf": dense((d, h), _F32),
            "bf": torch.full((h,), 3.0, dtype=_F32, device=device),
            "wog": dense((d, h, hd)), "wo": dense((h, hd, d))}


def _mlstm_heads(params: dict) -> bool:
    """Does each rank run its own mLSTM heads on the ambient mesh?  Where
    ``model`` splits ``wq`` by heads (it divides them); otherwise the
    mixer runs whole on every rank, its split weights gathered."""
    return shd.split(params, "wq", 1)


def _mlstm_proj(params: dict, cfg: ModelConfig, x: torch.Tensor,
                heads: bool = False):
    """q, k, v, the log gates and the output gate of x; with ``heads``
    those of this rank's heads, every weight read there (``_leaf``: the
    heads of ``wq``/``wk``/``wv``, ``wi``/``wf`` split on d all-gathered
    first, ``wog`` and ``bf`` whole)."""
    dt = cfg.cdtype
    dim = 1 if heads else None
    if heads:
        x = C.copy_to(x, "model")
    q = _proj(x, _leaf(params, "wq", dim), dt) * (cfg.head_dim ** -0.5)
    k = _proj(x, _leaf(params, "wk", dim), dt)
    v = _proj(x, _leaf(params, "wv", dim), dt)
    x32 = x.to(_F32)
    li = x32 @ _leaf(params, "wi", dim)                       # log input gate
    lf = F.logsigmoid(x32 @ _leaf(params, "wf", dim)
                      + _leaf(params, "bf", 0 if heads else None))
    og = torch.sigmoid(_proj(x, _leaf(params, "wog", dim), dt))
    return q, k, v, li, lf, og


def _mlstm_chunk(carry, qch, kch, vch, lich, lfch):
    """One chunk (B, Lc, H, ...) of the stabilized chunkwise form from the
    carry (C, n, m) at its start -> (h (B, Lc, H, hd), carry at its end)."""
    C_hat, n_hat, m_prev = carry
    Lc = qch.shape[1]
    b = torch.cumsum(lfch, dim=1)                             # (B, Lc, H)
    g = lich - b                                              # log source wts
    gmax = torch.cummax(g, dim=1).values
    m_i = b + torch.maximum(m_prev[:, None], gmax)            # (B, Lc, H)
    inter = torch.exp(b + m_prev[:, None] - m_i)
    # intra: D_ij = exp(b_i + g_j - m_i) for j <= i
    Dij = torch.exp(b[:, :, None] + g[:, None, :] - m_i[:, :, None])
    tri = torch.tril(torch.ones((Lc, Lc), dtype=_F32, device=qch.device))
    Dij = Dij * tri[None, :, :, None]
    sij = torch.einsum("blhk,bjhk->bljh", qch, kch) * Dij
    intra_num = torch.einsum("bljh,bjhk->blhk", sij, vch)
    intra_den = torch.sum(sij, dim=2)                         # (B, Lc, H)
    inter_num = torch.einsum("blhk,bhkv->blhv", qch, C_hat) * inter[..., None]
    inter_den = torch.einsum("blhk,bhk->blh", qch, n_hat) * inter
    num = intra_num + inter_num
    den = torch.maximum(torch.abs(intra_den + inter_den), torch.exp(-m_i))
    h = num / den[..., None]                                  # (B, Lc, H, hd)
    # state update to the chunk's end
    bL = b[:, -1]                                             # (B, H)
    m_new = m_i[:, -1]
    decay = torch.exp(bL + m_prev - m_new)
    src = torch.exp(bL[:, None] + g - m_new[:, None])         # (B, Lc, H)
    C_new = decay[:, :, None, None] * C_hat + torch.einsum(
        "bjh,bjhk,bjhv->bhkv", src, kch, vch)
    n_new = decay[:, :, None] * n_hat + torch.einsum("bjh,bjhk->bhk", src,
                                                     kch)
    return h, (C_new, n_new, m_new)


def _mlstm_run(params: dict, cfg: ModelConfig, x: torch.Tensor):
    """(y, the carry (C, n, m) at the last chunk, heads): the full pass,
    on this rank's heads where ``_mlstm_heads`` (the output projection's
    partial sums summed over ``model``)."""
    B, S, _ = x.shape
    Lc = min(cfg.mlstm_chunk, S)
    if S % Lc:
        raise ValueError(
            f"mLSTM takes a sequence length that is a multiple of its chunk: "
            f"S = {S}, mlstm_chunk = {cfg.mlstm_chunk}")
    heads = _mlstm_heads(params)
    q, k, v, li, lf, og = _mlstm_proj(params, cfg, x, heads)
    q, k, v = (t.to(_F32) for t in (q, k, v))
    state = _mlstm_zero(B, q.shape[2], cfg.head_dim, x.device)
    carry = (state["C"], state["n"], state["m"])
    hs = torch.empty(q.shape, dtype=_F32, device=x.device)
    with torch.profiler.record_function(SCAN_RANGE):
        for s0 in range(0, S, Lc):
            sl = slice(s0, s0 + Lc)
            hs[:, sl], carry = _mlstm_chunk(carry, q[:, sl], k[:, sl],
                                            v[:, sl], li[:, sl], lf[:, sl])
    del q, k, v
    out = hs.to(cfg.cdtype) * og
    y = _out_proj(out, _leaf(params, "wo", 0 if heads else None), cfg.cdtype)
    return (C.reduce_from(y, "model") if heads else y), carry, heads


def _mlstm_dims(cfg: ModelConfig) -> tuple:
    """The dimensions of C, n and m that ``model`` splits on the ambient
    mesh (``sharding.state_pspec``): C and n on their key dimension (2)
    where head_dim is ≥ 128 and divisible, else None."""
    H, hd = cfg.n_heads, cfg.head_dim
    return (_state_dim((1, H, hd, hd)), _state_dim((1, H, hd)),
            _state_dim((1, H)))


def mlstm_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, dict]:
    """(y, state): the full pass and its carry (C, n, m) at the last
    chunk.  On a mesh the carry of the rank's heads moves to the state's
    layout once (C and n split on their key dimension: one all-to-all
    each; whole: an all-gather)."""
    y, carry, heads = _mlstm_run(params, cfg, x)
    have = 1 if heads else None
    return y, {name: _relayout(t, have, want) for name, t, want in zip(
        ("C", "n", "m"), carry, _mlstm_dims(cfg))}


def mlstm_full(params: dict, cfg: ModelConfig, x: torch.Tensor
               ) -> torch.Tensor:
    return _mlstm_run(params, cfg, x)[0]


def _mlstm_zero(batch: int, heads: int, hd: int, device=None) -> dict:
    return {"C": L.filled((batch, heads, hd, hd), _F32, device),
            "n": L.filled((batch, heads, hd), _F32, device),
            "m": L.filled((batch, heads), _F32, device, -1e30)}


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    return _mlstm_zero(batch, cfg.n_heads, cfg.head_dim, device)


def _mlstm_step(q, k, v, li, lf, C_, n_, m_):
    """One decode step's recurrence from (C, n, m): (num, q·n, the new
    state), f32.  q/k/v (B, H, hd), li/lf (B, H)."""
    m_new = torch.maximum(lf + m_, li)
    decay = torch.exp(lf + m_ - m_new)
    src = torch.exp(li - m_new)
    C_ = decay[..., None, None] * C_ + src[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_ = decay[..., None] * n_ + src[..., None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, C_)
    return num, torch.einsum("bhk,bhk->bh", q, n_), (C_, n_, m_new)


def mlstm_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: dict) -> Tuple[torch.Tensor, dict]:
    """One token.  On a mesh with C split on its key dimension each rank
    updates its key block of every head: the rank's heads' q, k, v and
    gates are all-gathered (one exchange), q·C and q·n are partial sums
    over the key dimension, all-reduced once; the rank's heads leave
    through its part of ``wo``, summed over ``model``.  With the state
    whole, a rank's heads step their slice of it and the new slices are
    all-gathered."""
    heads = _mlstm_heads(params)
    q, k, v, li, lf, og = _mlstm_proj(params, cfg, x, heads)   # S = 1
    q, k, v = (t[:, 0].to(_F32) for t in (q, k, v))
    li, lf, og = li[:, 0], lf[:, 0], og[:, 0]
    h_loc = q.shape[1]
    first = shd.axis_index("model") * h_loc if heads else 0
    if _mlstm_dims(cfg)[0] is not None:        # C split by its key dim
        if heads:
            hd = q.shape[-1]
            packed = C.all_gather(torch.cat([q, k, v, li[..., None],
                                             lf[..., None]], -1), 1, "model")
            q, k, v = packed[..., :hd], packed[..., hd:2 * hd], \
                packed[..., 2 * hd:3 * hd]
            li, lf = packed[..., 3 * hd], packed[..., 3 * hd + 1]
        kb = state["C"].shape[2]
        k0 = shd.axis_index("model") * kb
        num, qn, (C_, n_, m_) = _mlstm_step(
            q[..., k0:k0 + kb], k[..., k0:k0 + kb], v, li, lf, state["C"],
            state["n"], state["m"])
        summed = C.all_reduce(torch.cat([num, qn[..., None]], -1), "model")
        num, qn = summed[..., :-1], summed[..., -1]
        num, qn = num[:, first:first + h_loc], qn[:, first:first + h_loc]
        m_mine = m_[:, first:first + h_loc]
    else:
        part = [t[:, first:first + h_loc] for t in (state["C"], state["n"],
                                                   state["m"])]
        num, qn, (C_, n_, m_) = _mlstm_step(q, k, v, li, lf, *part)
        m_mine = m_
        if heads:
            C_, n_, m_ = (C.all_gather(t, 1, "model") for t in (C_, n_, m_))
    den = torch.maximum(torch.abs(qn), torch.exp(-m_mine))
    h = (num / den[..., None]).to(cfg.cdtype) * og
    y = torch.einsum("bhk,hkd->bd", h, as_compute(
        _leaf(params, "wo", 0 if heads else None), cfg.cdtype))
    if heads:
        y = C.reduce_from(y, "model")
    state["C"], state["n"], state["m"] = C_, n_, m_
    return y[:, None], state


# ===========================================================================
# sLSTM (scalar memory, exponential gating, recurrent mixing)
# ===========================================================================

def init_slstm(generator: torch.Generator, cfg: ModelConfig,
               device=None) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    p = {}
    for name in _GATES:
        p[f"w{name}"] = L.dense_init(generator, (d, h, hd), cfg.pdtype,
                                     device=device)
    for name in _GATES:
        p[f"r{name}"] = L.dense_init(generator, (h, hd, hd), cfg.pdtype,
                                     scale=hd ** -0.5, device=device)
    p["bf"] = torch.full((h, hd), 3.0, dtype=_F32, device=device)
    p["wo_proj"] = L.dense_init(generator, (h, hd, d), cfg.pdtype,
                                device=device)
    return p


def _slstm_weights(params: dict, w_dim: Optional[int] = None,
                   r_dim: Optional[int] = None):
    """The four gates' input weights side by side, (d, 4·H·hd) laid out
    (d, H, 4, hd), and their recurrent weights per head, (H, hd, 4·hd), in
    f32; on a mesh with this rank's part of dimension ``w_dim`` of the
    input weights and ``r_dim`` of the recurrent ones (``_leaf``)."""
    ws = [_leaf(params, f"w{n}", w_dim).to(_F32) for n in _GATES]
    d, H, hd = ws[0].shape
    w = torch.cat([t.reshape(d, H, 1, hd) for t in ws], dim=2)
    r = torch.cat([_leaf(params, f"r{n}", r_dim).to(_F32) for n in _GATES],
                  dim=2)
    return w.reshape(d, -1), r


def _slstm_heads(cfg: ModelConfig) -> bool:
    """Does each rank run its own sLSTM heads on the ambient mesh (its
    ``model`` divides them)?"""
    tp = shd.ambient_axis_size("model")
    return tp > 1 and cfg.n_heads % tp == 0


def _slstm_proj(params: dict, cfg: ModelConfig, x: torch.Tensor,
                heads: bool = False):
    """(the four gates' input projections of x (..., d), (..., H', 4·hd)
    f32, the recurrent weights (H', hd, 4·hd), bf (H', 1, hd)): every
    head, or (``heads``) this rank's.  Where ``model`` splits the gates'
    input weights by rows (d), the partial products are summed once:
    reduce-scattered to the rank's heads, or all-reduced."""
    rows = all(shd.split(params, f"w{n}", 0) for n in _GATES)
    dim = 0 if heads else None
    w, r = _slstm_weights(params, 0 if rows else (1 if heads else None), dim)
    bf = _leaf(params, "bf", dim)[:, None]
    if rows:
        y = (C.scatter(x.to(_F32), -1, "model") @ w).unflatten(
            -1, (cfg.n_heads, -1))
        y = C.scatter_sum(y, -2, "model") if heads \
            else C.reduce_from(y, "model")
        return y, r, bf
    if heads:
        x = C.copy_to(x, "model")
    return (x.to(_F32) @ w).unflatten(-1, (-1, 4 * cfg.head_dim)), r, bf


def _slstm_step(x_proj: torch.Tensor, r: torch.Tensor, bf: torch.Tensor,
                state: tuple, out: Optional[torch.Tensor] = None) -> tuple:
    """One timestep.  x_proj (H, B, 4·hd): the input projections of the
    gates z, i, f, o side by side, f32; state (c, n, h, m) each (H, B, hd).
    The four recurrent products are one ``baddbmm`` onto x_proj.  Returns
    the new state, its h written to ``out`` when given (serving only:
    autograd takes no ``out=``)."""
    c, n, h, m = state
    hd = r.shape[1]
    pre = torch.baddbmm(x_proj, h, r)                         # (H, B, 4·hd)
    zp, ip, fp, op = pre.split(hd, dim=-1)
    z = torch.tanh(zp)
    lf = F.logsigmoid(fp + bf)                                # log forget
    lfm = lf + m
    m = torch.maximum(lfm, ip)                                # ip: log input
    i_s = torch.exp(ip - m)
    f_s = torch.exp(lfm - m)
    c = torch.addcmul(f_s * c, i_s, z)
    n = torch.clamp(torch.addcmul(i_s, f_s, n), min=1e-6)
    h = torch.mul(torch.sigmoid(op), c / n, out=out)
    return c, n, h, m


def _slstm_loop(proj: torch.Tensor, r: torch.Tensor, bf: torch.Tensor,
                state: tuple, hs: torch.Tensor, t0: int, t1: int) -> tuple:
    """Steps t0 ≤ t < t1 of the sLSTM loop over proj (S, H, B, 4·hd), h of
    step t written to hs[t].  Returns the state after step t1 − 1."""
    for t in range(t0, t1):
        state = _slstm_step(proj[t], r, bf, state, out=hs[t])
    return state


def _slstm_loop_grad(proj: torch.Tensor, r: torch.Tensor, bf: torch.Tensor,
                     state: tuple) -> tuple:
    """The loop as autograd records it: each step out of place, its h kept
    and stacked at the end.  The steps' inputs come from one ``unbind``,
    whose backward stacks their gradients once (indexing ``proj[t]`` would
    add a zero-filled proj-sized gradient a step).  Returns (hs (S, H, B,
    hd), the last state)."""
    hs = []
    for x_proj in proj.unbind(0):
        state = _slstm_step(x_proj, r, bf, state)
        hs.append(state[2])
    return torch.stack(hs), state


def _slstm_graphed(proj: torch.Tensor, r: torch.Tensor, bf: torch.Tensor,
                   state: tuple, hs: torch.Tensor, T: int) -> tuple:
    """The loop on the card with its launches replayed from a CUDA graph: T
    steps are captured once (reading a static (T, H, B, 4·hd) input block
    and state, writing a static h block and the state), and each later
    block is copied in, replayed and copied out — the same kernels on the
    same values as the plain loop, a few host launches per T steps.  The
    first block runs plainly on a side stream (the warm-up a capture
    needs), the last S mod T steps plainly after the graph."""
    S = proj.shape[0]
    sproj, shs = torch.empty_like(proj[:T]), torch.empty_like(hs[:T])
    sstate = tuple(torch.empty(hs.shape[1:], dtype=hs.dtype,
                               device=hs.device).copy_(t) for t in state)

    def block():
        for dst, src in zip(sstate, _slstm_loop(sproj, r, bf, sstate, shs,
                                                0, T)):
            dst.copy_(src)

    main, side = torch.cuda.current_stream(), torch.cuda.Stream()
    sproj.copy_(proj[:T])
    side.wait_stream(main)
    with torch.cuda.stream(side):
        block()
        side.synchronize()
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        block()
        graph.capture_end()
    main.wait_stream(side)
    hs[:T].copy_(shs)
    end = S - S % T
    for t0 in range(T, end, T):
        sproj.copy_(proj[t0:t0 + T])
        graph.replay()
        hs[t0:t0 + T].copy_(shs)
    del graph
    return _slstm_loop(proj, r, bf, sstate, hs, end, S)


def _state_hb(state: dict) -> tuple:
    """An sLSTM state dict (B, H, hd) per entry as (c, n, h, m) views laid
    out (H, B, hd)."""
    return tuple(state[k].transpose(0, 1) for k in ("c", "n", "h", "m"))


def _state_bh(state: tuple) -> dict:
    return {k: v.transpose(0, 1).contiguous()
            for k, v in zip(("c", "n", "h", "m"), state)}


def _slstm_run(params: dict, cfg: ModelConfig, x: torch.Tensor):
    """(y, the last state (c, n, h, m) laid out (H', B, hd), heads): the
    full pass, on this rank's heads where ``_slstm_heads`` (the gates'
    projections reduce-scattered to them before the loop, ``r*``, ``bf``
    and ``wo_proj`` read at them, the output's partial sums summed over
    ``model`` after it)."""
    B, S, _ = x.shape
    heads = _slstm_heads(cfg)
    proj, r, bf = _slstm_proj(params, cfg, x, heads)
    H, hd = proj.shape[2], cfg.head_dim
    # every token's input projections at once, laid out (S, H, B, 4·hd) so
    # each step's (H, B, 4·hd) slab is contiguous for baddbmm
    proj = proj.permute(1, 2, 0, 3).contiguous()
    state = _state_hb(_slstm_zero(B, H, hd, x.device))
    with torch.profiler.record_function(SLSTM_RANGE):
        if _records(x, *params.values()):
            # training: no in-place write, no CUDA graph (a replay records
            # no autograd graph)
            hs, state = _slstm_loop_grad(proj, r, bf, state)
        else:
            hs = torch.empty((S, H, B, hd), dtype=_F32, device=x.device)
            if x.is_cuda and S >= 2 * SLSTM_GRAPH_STEPS:
                state = _slstm_graphed(proj, r, bf, state, hs,
                                       SLSTM_GRAPH_STEPS)
            else:
                state = _slstm_loop(proj, r, bf, state, hs, 0, S)
    y = _out_proj(hs.permute(2, 0, 1, 3).to(cfg.cdtype),
                  _leaf(params, "wo_proj", 0 if heads else None), cfg.cdtype)
    return (C.reduce_from(y, "model") if heads else y), state, heads


def slstm_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, dict]:
    """(y, state): the full pass and its last step's state, on a mesh
    moved from the rank's heads to the state's layout once (split on
    head_dim: one all-to-all a leaf; whole: an all-gather)."""
    y, state, heads = _slstm_run(params, cfg, x)
    want = _state_dim((1, cfg.n_heads, cfg.head_dim))
    return y, {k: _relayout(t, 1 if heads else None, want)
               for k, t in _state_bh(state).items()}


def slstm_full(params: dict, cfg: ModelConfig, x: torch.Tensor
               ) -> torch.Tensor:
    return _slstm_run(params, cfg, x)[0]


def _slstm_zero(batch: int, heads: int, hd: int, device=None) -> dict:
    shape = (batch, heads, hd)
    return {"c": L.filled(shape, _F32, device),
            "n": L.filled(shape, _F32, device, 1e-6),
            "h": L.filled(shape, _F32, device),
            "m": L.filled(shape, _F32, device, -1e30)}


def init_slstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    return _slstm_zero(batch, cfg.n_heads, cfg.head_dim, device)


def slstm_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: dict) -> Tuple[torch.Tensor, dict]:
    """One token, every head on every rank.  On a mesh the gates' input
    products are all-reduced where their weights are split by rows, and a
    state split on head_dim is all-gathered once (its four leaves in one
    exchange); each rank keeps its part of the new state."""
    x_proj, r, bf = _slstm_proj(params, cfg, x[:, 0])         # (B, H, 4·hd)
    sdim = _state_dim((1, cfg.n_heads, cfg.head_dim))
    names = ("c", "n", "h", "m")
    if sdim is None:
        now = state
    else:
        whole = C.all_gather(torch.stack([state[k] for k in names]), 3,
                             "model")
        now = dict(zip(names, whole.unbind(0)))
    new = _state_bh(_slstm_step(x_proj.transpose(0, 1), r, bf,
                                _state_hb(now)))
    y = torch.einsum("bhk,hkd->bd", new["h"].to(cfg.cdtype),
                     as_compute(_leaf(params, "wo_proj"), cfg.cdtype))
    state.update({k: _relayout(t, None, sdim) for k, t in new.items()})
    return y[:, None], state


# ===========================================================================
# by kind
# ===========================================================================

INIT = {"rglru": init_rglru, "mlstm": init_mlstm, "slstm": init_slstm}
FULL = {"rglru": rglru_full, "mlstm": mlstm_full, "slstm": slstm_full}
PREFILL = {"rglru": rglru_prefill, "mlstm": mlstm_prefill,
           "slstm": slstm_prefill}
DECODE = {"rglru": rglru_decode, "mlstm": mlstm_decode,
          "slstm": slstm_decode}
INIT_STATE = {"rglru": init_rglru_state, "mlstm": init_mlstm_state,
              "slstm": init_slstm_state}
