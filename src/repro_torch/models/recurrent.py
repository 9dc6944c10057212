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

The reference has no Pallas kernel for any of this; these are torch ops.
The recurrences run inside ``torch.profiler.record_function`` ranges
(``SCAN_RANGE``, ``SLSTM_RANGE``) so a profile can class their kernels.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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


def _rglru_gates(params: dict, cfg: ModelConfig, u: torch.Tensor):
    """u: (..., w) post-conv input -> (log_a, b) of the recurrence, f32."""
    dt = cfg.cdtype
    r = torch.sigmoid(u @ as_compute(params["w_a"], dt)).to(_F32)
    i = torch.sigmoid(u @ as_compute(params["w_i"], dt)).to(_F32)
    log_a = -_RGLRU_C * F.softplus(params["lam"]) * r
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
    first token when S < K − 1)."""
    dt = cfg.cdtype
    B, S, _ = x.shape
    u_in = x @ as_compute(params["w_x"], dt)                 # pre-conv
    u = _causal_conv_full(u_in, as_compute(params["conv_k"], dt))
    K = cfg.rglru_conv_width
    conv = (F.pad(u_in, (0, 0, max(K - 1 - S, 0), 0))[:, -(K - 1):]
            if K > 1 else u_in[:, :0]).contiguous()
    del u_in
    hb = torch.empty_like(u)
    h_last = None
    with torch.profiler.record_function(SCAN_RANGE):
        for s0 in range(0, S, SCAN_CHUNK):
            log_a, b = _rglru_gates(params, cfg, u[:, s0:s0 + SCAN_CHUNK])
            h = linear_scan(log_a, b, h_last)
            del log_a, b
            h_last = h[:, -1].clone()
            hb[:, s0:s0 + SCAN_CHUNK] = h.to(dt)
            del h
    del u
    gate = F.gelu(x @ as_compute(params["w_gate"], dt), approximate="tanh")
    y = (hb * gate) @ as_compute(params["w_out"], dt)
    return y, {"h": h_last, "conv": conv}


def rglru_full(params: dict, cfg: ModelConfig, x: torch.Tensor
               ) -> torch.Tensor:
    return rglru_prefill(params, cfg, x)[0]


def init_rglru_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=_F32, device=device),
            "conv": torch.zeros((batch, cfg.rglru_conv_width - 1, w),
                                dtype=cfg.cdtype, device=device)}


def rglru_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: dict) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, d)."""
    dt = cfg.cdtype
    xt = x[:, 0]
    gate = F.gelu(xt @ as_compute(params["w_gate"], dt), approximate="tanh")
    u_new = xt @ as_compute(params["w_x"], dt)                # (B, w)
    hist = torch.cat([state["conv"], u_new[:, None]], dim=1)  # (B, K, w)
    u = torch.einsum("bkw,kw->bw", hist, as_compute(params["conv_k"], dt))
    log_a, b = _rglru_gates(params, cfg, u)
    h = torch.exp(log_a) * state["h"] + b
    y = (h.to(dt) * gate) @ as_compute(params["w_out"], dt)
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


def _mlstm_proj(params: dict, cfg: ModelConfig, x: torch.Tensor):
    dt = cfg.cdtype
    q = _proj(x, params["wq"], dt) * (cfg.head_dim ** -0.5)
    k = _proj(x, params["wk"], dt)
    v = _proj(x, params["wv"], dt)
    x32 = x.to(_F32)
    li = x32 @ params["wi"]                                   # log input gate
    lf = F.logsigmoid(x32 @ params["wf"] + params["bf"])      # log forget
    og = torch.sigmoid(_proj(x, params["wog"], dt))
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


def mlstm_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, dict]:
    """(y, state): the full pass and its carry (C, n, m) at the last
    chunk."""
    B, S, _ = x.shape
    Lc = min(cfg.mlstm_chunk, S)
    if S % Lc:
        raise ValueError(
            f"mLSTM takes a sequence length that is a multiple of its chunk: "
            f"S = {S}, mlstm_chunk = {cfg.mlstm_chunk}")
    q, k, v, li, lf, og = _mlstm_proj(params, cfg, x)
    q, k, v = (t.to(_F32) for t in (q, k, v))
    state = init_mlstm_state(cfg, B, x.device)
    carry = (state["C"], state["n"], state["m"])
    hs = torch.empty(q.shape, dtype=_F32, device=x.device)
    with torch.profiler.record_function(SCAN_RANGE):
        for s0 in range(0, S, Lc):
            sl = slice(s0, s0 + Lc)
            hs[:, sl], carry = _mlstm_chunk(carry, q[:, sl], k[:, sl],
                                            v[:, sl], li[:, sl], lf[:, sl])
    del q, k, v
    out = hs.to(cfg.cdtype) * og
    y = _out_proj(out, params["wo"], cfg.cdtype)
    return y, dict(zip(("C", "n", "m"), carry))


def mlstm_full(params: dict, cfg: ModelConfig, x: torch.Tensor
               ) -> torch.Tensor:
    return mlstm_prefill(params, cfg, x)[0]


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    H, hd = cfg.n_heads, cfg.head_dim
    return {"C": torch.zeros((batch, H, hd, hd), dtype=_F32, device=device),
            "n": torch.zeros((batch, H, hd), dtype=_F32, device=device),
            "m": torch.full((batch, H), -1e30, dtype=_F32, device=device)}


def mlstm_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: dict) -> Tuple[torch.Tensor, dict]:
    q, k, v, li, lf, og = _mlstm_proj(params, cfg, x)         # S = 1
    q, k, v = (t[:, 0].to(_F32) for t in (q, k, v))
    li, lf, og = li[:, 0], lf[:, 0], og[:, 0]
    m_new = torch.maximum(lf + state["m"], li)
    decay = torch.exp(lf + state["m"] - m_new)
    src = torch.exp(li - m_new)
    C = decay[..., None, None] * state["C"] + src[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = decay[..., None] * state["n"] + src[..., None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, C)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", q, n)),
                        torch.exp(-m_new))
    h = (num / den[..., None]).to(cfg.cdtype) * og
    y = torch.einsum("bhk,hkd->bd", h, as_compute(params["wo"], cfg.cdtype))
    state["C"], state["n"], state["m"] = C, n, m_new
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


def _slstm_weights(params: dict):
    """The four gates' input weights side by side, (d, 4·H·hd), and their
    recurrent weights per head, (H, hd, 4·hd), in f32."""
    H, hd = params["rz"].shape[:2]
    w = torch.cat([params[f"w{n}"].to(_F32).reshape(-1, H, 1, hd)
                   for n in _GATES], dim=2)                   # (d, H, 4, hd)
    r = torch.cat([params[f"r{n}"].to(_F32) for n in _GATES], dim=2)
    return w.reshape(w.shape[0], -1), r


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


def slstm_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, dict]:
    """(y, state): the full pass and its last step's state."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    w, r = _slstm_weights(params)
    # every token's input projections at once, laid out (S, H, B, 4·hd) so
    # each step's (H, B, 4·hd) slab is contiguous for baddbmm
    proj = (x.to(_F32) @ w).view(B, S, H, 4 * hd).permute(1, 2, 0, 3)
    proj = proj.contiguous()
    bf = params["bf"][:, None]                                # (H, 1, hd)
    state = _state_hb(init_slstm_state(cfg, B, x.device))
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
    y = _out_proj(hs.permute(2, 0, 1, 3).to(cfg.cdtype), params["wo_proj"],
                  cfg.cdtype)
    return y, _state_bh(state)


def slstm_full(params: dict, cfg: ModelConfig, x: torch.Tensor
               ) -> torch.Tensor:
    return slstm_prefill(params, cfg, x)[0]


def init_slstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    H, hd = cfg.n_heads, cfg.head_dim
    z = torch.zeros((batch, H, hd), dtype=_F32, device=device)
    return {"c": z, "n": torch.full_like(z, 1e-6), "h": z.clone(),
            "m": torch.full_like(z, -1e30)}


def slstm_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: dict) -> Tuple[torch.Tensor, dict]:
    w, r = _slstm_weights(params)
    x_proj = (x[:, 0].to(_F32) @ w).view(x.shape[0], cfg.n_heads, -1)
    state.update(_state_bh(_slstm_step(x_proj.transpose(0, 1), r,
                                       params["bf"][:, None],
                                       _state_hb(state))))
    y = torch.einsum("bhk,hkd->bd", state["h"].to(cfg.cdtype),
                     as_compute(params["wo_proj"], cfg.cdtype))
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
