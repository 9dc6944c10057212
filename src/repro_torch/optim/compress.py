"""Sketched gradient compression for the cross-pod all-reduce (port of
``repro.optim.compress``).

The paper's Lemma-2 toolbox (here: CountSketch, the O(nnz) family member) is
reused as a *distributed-optimization* trick: before the slow cross-pod
all-reduce, each pod compresses its gradient block ``g`` to ``Sᵀ g`` with a
shared CountSketch S ∈ R^{n×s} (s = max(1, n // ratio)), all-reduces the
sketch, and unsketches with ``S (Sᵀ g)``.  Error feedback keeps the
residual ``e = g − δ·S Sᵀ g`` locally and adds it to the next step's
gradient, so the compression error does not accumulate.

CountSketch is linear, so ``allreduce(Sᵀ g_i) = Sᵀ (Σ g_i)``.  Every pod must
agree on S without communication: the hash and sign tables are drawn from
a ``torch.Generator`` carried in ``CompressorState``, seeded alike on every
pod.  JAX keys and torch generators never give the same stream, so
``countsketch_compress`` also takes explicit ``(hashes, signs)`` tables in
place of the generator (the reference's own, in the parity tests).

Why the *damped* unsketch: ``S Sᵀ`` is unbiased but NOT a contraction, so
naive error feedback diverges; δ = 1/(1 + ratio) makes ``I − δ·S Sᵀ`` a
contraction in expectation (see the reference's module docstring).

Sᵀ g is a segment sum, an ``index_add_`` into s buckets; S (Sᵀ g) a gather.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple, \
    Union

import torch

from repro_torch.optim.optimizers import tree_leaves, tree_map, \
    tree_unflatten

_F32 = torch.float32
Tables = Tuple[torch.Tensor, torch.Tensor]


class CompressorState(NamedTuple):
    error: dict                  # per-leaf residual feedback (f32, grads')
    generator: torch.Generator   # the hash and sign tables are drawn here


def leaf_tables(generator: torch.Generator, n: int, s: int,
                device=None) -> Tables:
    """(hashes (n,) int64 in [0, s), signs (n,) f32 ±1), drawn on the
    generator's device and moved to ``device``."""
    hashes = torch.randint(0, s, (n,), generator=generator,
                           device=generator.device)
    signs = torch.randint(0, 2, (n,), generator=generator,
                          device=generator.device).to(_F32).mul_(2).sub_(1)
    device = generator.device if device is None else device
    return hashes.to(device), signs.to(device)


def countsketch_compress(g: torch.Tensor,
                         key: Union[torch.Generator, Sequence[torch.Tensor]],
                         ratio: int) -> Tuple[torch.Tensor, tuple]:
    """g (any shape) -> (sketch (s,) f32 with s = max(1, n // ratio),
    meta).  ``key`` is a generator the tables are drawn from, or explicit
    ``(hashes, signs)``."""
    flat = g.reshape(-1).to(_F32)
    n = flat.shape[0]
    s = max(1, n // ratio)
    if isinstance(key, torch.Generator):
        hashes, signs = leaf_tables(key, n, s, g.device)
    else:
        hashes = torch.as_tensor(key[0], device=g.device).to(torch.int64)
        signs = torch.as_tensor(key[1], device=g.device).to(_F32)
    sk = torch.zeros((s,), dtype=_F32, device=g.device).index_add_(
        0, hashes, flat * signs)
    return sk, (hashes, signs, g.shape, g.dtype)


def countsketch_decompress(sk: torch.Tensor, meta) -> torch.Tensor:
    hashes, signs, shape, dtype = meta
    rec = sk[hashes] * signs
    return rec.reshape(shape).to(dtype)


def make_gradient_compressor(ratio: int = 8):
    """Returns (init, apply).

    ``apply(grads, state, allreduce_fn, tables=None) -> (grads_hat,
    new_state)`` where ``allreduce_fn`` averages a sketch over the pods
    (the identity in single-pod runs and tests; it may work in place).
    Error feedback is carried in ``state``; the generator advances by one
    pair of tables per leaf.  ``tables`` (one ``(hashes, signs)`` per leaf,
    in ``tree_leaves`` order) replaces the draws.
    """
    def init(grads_like, generator: torch.Generator) -> CompressorState:
        return CompressorState(
            error=tree_map(lambda g: torch.zeros(g.shape, dtype=_F32,
                                                 device=g.device),
                           grads_like),
            generator=generator)

    delta = 1.0 / (1.0 + ratio)                # contraction damping

    def apply(grads, state: CompressorState,
              allreduce_fn: Callable[[torch.Tensor], torch.Tensor],
              tables: Optional[List[Tables]] = None):
        flat = tree_leaves(grads)
        eflat = tree_leaves(state.error)
        out, new_err = [], []
        for i, (g, e) in enumerate(zip(flat, eflat)):
            gc = g.to(_F32) + e                              # error feedback
            key = state.generator if tables is None else tables[i]
            sk, meta = countsketch_compress(gc, key, ratio)
            local_rec = delta * countsketch_decompress(sk, meta).to(_F32)
            rec = delta * countsketch_decompress(
                allreduce_fn(sk.clone()), meta).to(_F32)
            new_err.append(gc - local_rec)
            out.append(rec.to(g.dtype))
        error = tree_unflatten(state.error, iter(new_err))
        return (tree_unflatten(grads, iter(out)),
                CompressorState(error=error, generator=state.generator))

    return init, apply
