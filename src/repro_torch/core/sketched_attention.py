"""Landmark (sketched) attention — the paper's fast CUR applied to attention
(port of ``repro.core.sketched_attention``).

Full attention computes ``softmax(QKᵀ/√d) V``.  With ``G = exp(QKᵀ/√d)``,
``out = (G V) / (G 1)``.  G is approximated once with the paper's fast CUR
(Eq. 9) and the factors serve both the numerator and the normalizer:

    G ≈ Ĉ Ũ R̂,   Ĉ = exp(Q K_Pᵀ/√d) (m×c),   R̂ = exp(Q_P Kᵀ/√d) (c×n),
    Ũ = (S_qᵀĈ)† (S_qᵀ G S_k) (R̂ S_k)†        — fast-CUR U, s = θ·c.

Nyström is the S = P case and the prototype the S = I case.  For decode
against a fixed context, ``build_landmark_state`` caches Ũ(R̂V) and Ũ(R̂1)
and ``landmark_decode`` reads them through the fused landmark-read kernel
(``repro_torch.kernels.landmark_attention``).  The exp-score panels and the
small U products are ``torch.matmul``, as the reference leaves them to XLA.

Landmarks are strided with jitter by default; any registered
``SelectionPolicy`` name picks them from the context's softmax Gram
``exp(K Kᵀ/√d − offset)`` instead — a ``PairwiseKernel`` whose spec carries
the ``exp_affine`` epilogue, so the selection sweeps run on the pairwise
kernels.

Randomness: each entry point takes a ``torch.Generator`` and the explicit
draws — ``p_idx`` (landmarks), ``sq``/``skx`` (row and column sketch
indices) — so tests can hand the reference's draws to the port.  Draws left
to the generator are taken in the order p_idx, skx, sq.  Entry points run on
the CUDA device unless ``device=`` says otherwise.
"""
from __future__ import annotations

import functools
import warnings
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import selection as selection_lib
from repro_torch.core.cur import fast_U_cur
from repro_torch.core.kernelop import PairwiseKernel
from repro_torch.core.leverage import pinv
from repro_torch.device import generator_or_default, resolve_device
from repro_torch.kernels.landmark_attention import ops as lm_ops
from repro_torch.kernels.landmark_attention.ref import inv_sqrt_d
# floor |den| at eps keeping its sign, so num/den is invariant to a global
# sign flip of Ũ and only division blow-up is guarded
from repro_torch.kernels.landmark_attention.ref import \
    signed_floor as signed_den_floor
from repro_torch.kernels.pairwise.specs import Epilogue, KernelSpec

_F32 = torch.float32
MODES = ("fast", "nystrom", "prototype")


class LandmarkState(NamedTuple):
    """Decode-time cache: everything that depends only on the context K/V."""
    k_land: torch.Tensor    # (c, d)   landmark keys
    UV: torch.Tensor        # (c, d_v) Ũ @ (R̂ V)
    U1: torch.Tensor        # (c,)     Ũ @ (R̂ 1)
    scale: torch.Tensor     # ()       max-logit offset used inside exp


def _exp_scores(Q: torch.Tensor, K: torch.Tensor, inv: float,
                offset: torch.Tensor) -> torch.Tensor:
    return torch.exp((Q @ K.T).to(_F32) * inv - offset)


def _index(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def landmark_indices(n: int, c: int, generator: torch.Generator,
                     device=None) -> torch.Tensor:
    """Strided landmarks with per-segment jitter: c distinct positions for
    c < n.  c ≥ n clamps to all n positions (distinct), with a warning when
    c > n."""
    device = generator.device if device is None else device
    if c >= n:
        if c > n:
            warnings.warn(
                f"landmark_indices: requested c={c} >= n={n}; clamping to "
                "all n distinct positions", stacklevel=2)
        return torch.randperm(n, generator=generator,
                              device=generator.device).to(device)
    seg = n // c
    base = torch.arange(c, device=generator.device) * seg
    jitter = torch.randint(0, max(seg, 1), (c,), generator=generator,
                           device=generator.device)
    return torch.clamp(base + jitter, 0, n - 1).to(device)


@functools.lru_cache(maxsize=None)
def _softmax_gram_spec(inv_sqrt: float, offset: float) -> KernelSpec:
    """Unregistered spec of the context softmax Gram exp(KKᵀ/√d − off):
    kept out of the registry the parity suites iterate over, and cached per
    (scale, offset) because specs compare by field identity."""
    return KernelSpec(
        "softmax_gram", "dot",
        lambda t: torch.exp(t * inv_sqrt - offset),
        params=(("inv_sqrt_d", inv_sqrt), ("offset", offset)),
        epilogue=Epilogue("exp_affine", a=inv_sqrt, b=offset))


def softmax_gram_operator(K: torch.Tensor) -> PairwiseKernel:
    """exp(K Kᵀ/√d − offset) as a ``PairwiseKernel`` on K's device.

    offset = max_i ‖k_i‖²/√d rounded to 3 decimals (diagonal logits ≤ 0):
    one scalar read to the host, as the reference's ``float(...)``."""
    d = K.shape[1]
    inv = 1.0 / float(d) ** 0.5
    offset = round(float(torch.max(torch.sum(K.to(_F32) ** 2, dim=1)))
                   * inv, 3)
    return PairwiseKernel(K.to(_F32), _softmax_gram_spec(inv, offset),
                          device=K.device)


def select_landmarks(K: torch.Tensor, c: int, selection: str = "strided",
                     block_size: Optional[int] = None, *,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """Pick c landmark key positions.

    ``"strided"`` is the Nyströmformer layout (``landmark_indices``); any
    other name resolves through the selection registry and selects columns
    of ``softmax_gram_operator(K)`` — streamed through the sweep engine, no
    n×n matrix.
    """
    n = K.shape[0]
    g = generator_or_default(generator)
    if selection == "strided":
        return landmark_indices(n, c, g, K.device)
    policy = selection_lib.get_policy(selection)
    return policy.select(softmax_gram_operator(K), min(c, n), generator=g,
                         block_size=block_size)


def _extend_without_replacement(base: torch.Tensor, s: int, n: int,
                                generator: torch.Generator) -> torch.Tensor:
    """``base`` plus (s − |base|) distinct indices from its complement, so
    the sketch sets hold no repeated rows or columns."""
    extra = s - base.shape[0]
    if extra <= 0:
        return base[:s]
    w = torch.ones((n,), dtype=_F32, device=generator.device)
    w[base.to(generator.device)] = 0.0
    ext = torch.multinomial(w / torch.sum(w), extra, replacement=False,
                            generator=generator)
    return torch.cat([base, ext.to(base.device)])


def _sketch_indices(p_idx: torch.Tensor, m: int, n: int, c: int, theta: int,
                    generator: torch.Generator):
    """Row (queries) and column (keys) sketch index sets for Eq. 9.

    The column sketch extends the landmarks (P ⊂ S, §4.5); the row sketch
    mirrors it when the Gram is square (m == n), else it is a plain
    without-replacement sample of [0, m).
    """
    s_k = min(theta * c, n)
    skx = _extend_without_replacement(p_idx, s_k, n, generator)
    if m == n:
        sq = _extend_without_replacement(p_idx, s_k, m, generator)
    else:
        s_q = min(theta * c, m)
        sq = torch.randperm(m, generator=generator,
                            device=generator.device)[:s_q].to(p_idx.device)
    return sq, skx


def sketched_attention(Q, K, V, c: int, theta: int = 4, mode: str = "fast",
                       selection: str = "strided", *,
                       generator: Optional[torch.Generator] = None,
                       p_idx=None, sq=None, skx=None,
                       device=None) -> torch.Tensor:
    """Non-causal sketched attention of Q (m, d) over a context K (n, d),
    V (n, d_v); ``mode`` is ``fast``, ``nystrom`` or ``prototype``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if (sq is None) != (skx is None):
        raise ValueError("pass both sq and skx, or neither")
    device = resolve_device(device)
    Q, K, V = (torch.as_tensor(x, device=device) for x in (Q, K, V))
    m, d = Q.shape
    n = K.shape[0]
    inv = inv_sqrt_d(d)
    g = generator_or_default(generator)

    if p_idx is None:
        p_idx = select_landmarks(K, c, selection=selection, generator=g)
    p_idx = _index(p_idx, device)
    c = p_idx.shape[0]            # may have been clamped to n
    Kp = K[p_idx]
    Qp = Q[p_idx] if m == n else Kp

    # stabilization offset: the max landmark logit
    offset = torch.max((Qp @ Kp.T).to(_F32)) * inv

    Chat = _exp_scores(Q, Kp, inv, offset)              # (m, c)
    Rhat = _exp_scores(Qp, K, inv, offset)              # (c, n)

    if mode == "prototype":                              # S = I
        G = _exp_scores(Q, K, inv, offset)
        U = pinv(Chat) @ G @ pinv(Rhat)
    elif mode == "nystrom":                              # S = P
        U = pinv(_exp_scores(Qp, Kp, inv, offset))
    else:                                                # fast CUR (Eq. 9)
        if sq is None:
            sq, skx = _sketch_indices(p_idx, m, n, c, theta, g)
        sq, skx = _index(sq, device), _index(skx, device)
        G_blk = _exp_scores(Q[sq], K[skx], inv, offset)
        U = fast_U_cur(Chat[sq], G_blk, Rhat[:, skx])

    num = Chat @ (U @ (Rhat @ V.to(_F32)))               # (m, d_v)
    den = Chat @ (U @ torch.sum(Rhat, dim=1))            # (m,)
    return (num / signed_den_floor(den)[:, None]).to(V.dtype)


# ---------------------------------------------------------------------------
# Decode path: O(c) per token against a long context
# ---------------------------------------------------------------------------

def landmark_draws(K: torch.Tensor, c: int, theta: int = 4,
                   selection: str = "strided", *,
                   generator: Optional[torch.Generator] = None,
                   p_idx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p_idx, skx): the c landmarks of K (n, d) (``selection``; ``p_idx``
    where given) and the column sketch of min(theta·c, n) positions that
    extends them, drawn from ``generator`` in that order, as
    ``build_landmark_state`` draws them where it is given none."""
    n = K.shape[0]
    g = generator_or_default(generator)
    if p_idx is None:
        p_idx = select_landmarks(K, c, selection=selection, generator=g)
    p_idx = _index(p_idx, K.device)
    return p_idx, _extend_without_replacement(
        p_idx, min(theta * p_idx.shape[0], n), n, g)


def build_landmark_state(K, V, c: int, theta: int = 4,
                         selection: str = "strided", *,
                         generator: Optional[torch.Generator] = None,
                         p_idx=None, skx=None,
                         device=None) -> LandmarkState:
    """Precompute the context-side factors once (prefill)."""
    device = resolve_device(device)
    K, V = (torch.as_tensor(x, device=device) for x in (K, V))
    n, d = K.shape
    inv = inv_sqrt_d(d)
    g = generator_or_default(generator)
    if skx is None:
        p_idx, skx = landmark_draws(K, c, theta, selection, generator=g,
                                    p_idx=p_idx)
    elif p_idx is None:
        p_idx = select_landmarks(K, c, selection=selection, generator=g)
    p_idx = _index(p_idx, device)
    c = p_idx.shape[0]            # may have been clamped to n
    Kp = K[p_idx]
    offset = torch.max((Kp @ Kp.T).to(_F32)) * inv

    Rhat = _exp_scores(Kp, K, inv, offset)               # (c, n)
    skx = _index(skx, device)
    # queries at the sketched rows are the sketched keys (self-Gram)
    Ks = K[skx]
    U = fast_U_cur(_exp_scores(Ks, Kp, inv, offset),
                   _exp_scores(Ks, Ks, inv, offset), Rhat[:, skx])

    RV = Rhat @ V.to(_F32)                               # (c, d_v)
    R1 = torch.sum(Rhat, dim=1)                          # (c,)
    return LandmarkState(k_land=Kp, UV=U @ RV, U1=U @ R1, scale=offset)


def landmark_decode(state: LandmarkState, q: torch.Tensor) -> torch.Tensor:
    """Attention read of a (d,) query -> (d_v,), or of (m, d) queries ->
    (m, d_v), O(c·d) each — the fused landmark read (one kernel launch on
    the card)."""
    q2 = q[None] if q.ndim == 1 else q
    out = lm_ops.landmark_read(q2, state.k_land, state.UV, state.U1,
                               state.scale)
    return out[0] if q.ndim == 1 else out
