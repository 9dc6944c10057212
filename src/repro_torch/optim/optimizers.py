"""Optimizers as (init, update) pairs over parameter trees (port of
``repro.optim.optimizers``).

- ``adamw``     : decoupled weight decay, f32 moments, global-norm clipping.
- ``adafactor`` : factored second moment over the trailing two dims of each
                  matrix + optional bf16 first moment — the memory-frugal
                  choice for the ≥100B configs (deepseek-v3).
- ``lion``      : sign-momentum; 4 bytes/param state.

A tree is nested dicts, lists and tuples of tensors, as the model's params
are; dict keys are visited in sorted order, as ``jax.tree`` flattens them.
The arithmetic is the reference's, leaf by leaf: f32 moments, the bias
correction from the incremented step, decoupled decay, Adafactor's update
clipping (RMS(u) ≤ 1) and bf16 momentum.  ``update`` writes the new
parameters and moments into the given tensors in place, under
``torch.no_grad()`` (so a step holds no second copy of the weights), and
returns the same dicts with a new ``OptState``; ``step`` is a 0-d int32
tensor on the params' device, so no step reads the host.

**On a mesh** (``update(..., mesh=, specs=)`` and ``init(..., mesh=,
specs=)``, ``specs`` the spec of each parameter leaf in ``tree_leaves``
order, as ``launch.steps`` threads them) the params, gradients and every
state leaf of a parameter's shape are this rank's shards.  adamw and lion
are elementwise and read no layout.  adafactor's factored statistics are
whole and replicated, as the reference lays them out
(``launch.steps._opt_shardings``): a row or column mean is formed from
local sums added over the axes that split the reduced dimension, in rank
order (``collectives.ordered_sum``: every rank forms the same bits), and
all-gathered over the axes that split the kept ones; ``vhat`` is read at
the local block.  The update's RMS clip sums u² over the axes that split
each leaf (a replicated leaf counts once) and divides by the global
count.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, List, NamedTuple, Optional

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd

_F32 = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor
    inner: Any                      # per-optimizer tree (m, v, ...)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], OptState]
    update: Callable[..., tuple]
    # init(params, mesh=None, specs=None) -> state
    # update(grads, state, params, lr, gnorm=None, mesh=None, specs=None)
    #     -> (params, state, metrics);
    # ``gnorm``: the gradients' global norm where the caller formed it;
    # ``mesh``/``specs``: the leaves are shards (see the module docstring)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> List[Any]:
    """The leaves in the reference's order (sorted dict keys, sequences in
    order); ``None`` is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _flatten_upto(tree, like) -> List[Any]:
    """The nodes of ``tree`` at the leaf positions of ``like`` (a state
    tree that holds a dict of statistics per parameter)."""
    if like is None:
        return []
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in _flatten_upto(tree[k],
                                                              like[k])]
    if isinstance(like, (list, tuple)):
        return [x for a, b in zip(tree, like) for x in _flatten_upto(a, b)]
    return [tree]


def tree_unflatten(like, leaves: Iterator):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: tree_unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(tree_unflatten(v, leaves) for v in like)
    return next(leaves)


def tree_map(fn: Callable, tree):
    """``tree`` with ``fn`` applied to every leaf."""
    return tree_unflatten(tree, iter([fn(x) for x in tree_leaves(tree)]))


def _device(params) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(_F32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    # ``max_norm / x`` as a true division (a Python scalar over a tensor
    # would multiply by the reciprocal)
    return torch.clamp(torch.div(torch.full_like(gn, max_norm),
                                 torch.clamp(gn, min=1e-12)), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    gn = global_norm(tree)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda x: x.to(_F32) * scale, tree), gn


def _grads_f32(grads: List[torch.Tensor], clip_norm: Optional[float],
               gn: Optional[torch.Tensor] = None):
    """(a function giving leaf i's gradient in f32, clipped as the
    reference clips the tree, global norm); leaves are made one at a
    time, so no clipped copy of the whole tree is held.  ``gn`` is the
    global norm when the caller formed it (the leaves are local shards of
    a mesh: ``launch.steps``)."""
    gn = global_norm(grads) if gn is None else gn
    if clip_norm is None:
        return (lambda i: grads[i].to(_F32)), gn
    scale = _clip_scale(gn, clip_norm)
    return (lambda i: grads[i].to(_F32) * scale), gn


def _is_matrix(shape) -> bool:
    return len(shape) >= 2 and min(shape[-2:]) >= 2


def _apply(p: torch.Tensor, u: torch.Tensor, lr, weight_decay: float
           ) -> None:
    """p ← p − lr·(u + wd·p) in f32, stored in p's dtype; ``u`` is
    consumed."""
    p32 = p if p.dtype == _F32 else p.to(_F32)
    if weight_decay:
        u.add_(weight_decay * p32)
    u.mul_(lr)
    if p.dtype == _F32:
        p.sub_(u)
    else:
        p.copy_(p32 - u)


def _zeros(dtype=_F32):
    return lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(params))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: Optional[float] = 1.0
          ) -> Optimizer:
    def init(params, mesh=None, specs=None):
        return OptState(step=_step0(params),
                        inner={"m": tree_map(_zeros(), params),
                               "v": tree_map(_zeros(), params)})

    @torch.no_grad()
    def update(grads, state, params, lr, gnorm=None, mesh=None, specs=None):
        flat_p = tree_leaves(params)
        flat_m = tree_leaves(state.inner["m"])
        flat_v = tree_leaves(state.inner["v"])
        grad_of, gn = _grads_f32(_flatten_upto(grads, params), clip_norm,
                                 gnorm)
        t = state.step + 1
        tf = t.to(_F32)
        bc1 = 1.0 - b1 ** tf
        bc2 = 1.0 - b2 ** tf
        for i, (p, m, v) in enumerate(zip(flat_p, flat_m, flat_v)):
            g = grad_of(i)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            del g
            u = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))
            _apply(p, u, lr, weight_decay)
        return params, OptState(step=t, inner=state.inner), {"grad_norm": gn}

    return Optimizer("adamw", init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored v; optional bf16 momentum)
# ---------------------------------------------------------------------------

def _leaf_groups(params, stacks: Optional[Callable]) -> List[List[int]]:
    """Indices into ``tree_leaves(params)`` grouped by stacked tensor: the
    leaves at one place in every layer of a ``stacks(params)`` list form
    one group, every other leaf is a group of its own."""
    pos = {id(p): i for i, p in enumerate(tree_leaves(params))}
    groups = []
    for layers in (stacks(params) if stacks is not None else []):
        for column in zip(*(tree_leaves(t) for t in layers)):
            groups.append([pos.pop(id(p)) for p in column])
    return groups + [[i] for i in sorted(pos.values())]


def _across_layers(shape, n: int) -> bool:
    """A vector (of ``shape``) in a stack of ``n`` layers whose stacked
    (n, d) is a matrix: the reference factors it across the layers."""
    return n >= 2 and len(shape) == 1 and shape[0] >= 2


# ---------------------------------------------------------------------------
# leaves split over a mesh (adafactor's statistics)
# ---------------------------------------------------------------------------

def _whole_shape(p: torch.Tensor, axes: list, mesh) -> tuple:
    """The shape of the whole tensor of the block ``p``, dimension d split
    over ``axes[d]``."""
    return tuple(n * C.axes_size(a, mesh) if a else n
                 for n, a in zip(p.shape, axes))


def _mean_over(t: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    """The mean over ``dim`` of the whole tensor whose block ``t`` is,
    that dimension split over ``axes``: local sums added in rank order."""
    if not axes:
        return torch.mean(t, dim=dim)
    n = t.shape[dim] * C.axes_size(axes, mesh)
    return C.ordered_sum(torch.sum(t, dim=dim), axes, mesh) / n


def adafactor(weight_decay: float = 0.0, eps: float = 1e-30,
              clip_norm: Optional[float] = 1.0, momentum: bool = False,
              decay: float = 0.8, stacks: Optional[Callable] = None
              ) -> Optimizer:
    """Factored second moment over the trailing two dims of each matrix.

    State per matrix param (..., r, c): row stats (..., r) + col stats
    (..., c) — ~0 bytes/param vs Adam's 8.

    The port keeps one tensor a layer; the reference under ``scan_layers``
    (its default) stacks a pattern slot's layers on a leading axis, which
    its adafactor sees as one tensor.  ``stacks(params)`` (the model's
    ``stacked_layers``) lists those per-layer trees, and each is updated as
    the reference updates the stacked tensor: the update clipped by the RMS
    over all its layers, and a vector (d,) factored across them as the
    matrix (layers, d) — a scalar row statistic in each layer, the (d,)
    column statistic shared and kept in each.  Without ``stacks`` every
    tensor is its own (``scan_layers=False``).

    On a mesh the statistics are whole on every rank (``init`` sizes them
    from the local shards and their specs) and the params, gradients and
    momentum are shards: see the module's docstring.
    """
    def init(params, mesh=None, specs=None):
        flat = tree_leaves(params)
        n_of = {i: len(g) for g in _leaf_groups(params, stacks) for i in g}
        specs = specs or [None] * len(flat)

        def stats(i, p):
            shape = _whole_shape(p, shd.split_axes(specs[i], p.ndim, mesh),
                                 mesh)
            if _is_matrix(shape):
                return {"r": torch.zeros(shape[:-1], dtype=_F32,
                                         device=p.device),
                        "c": torch.zeros(shape[:-2] + shape[-1:],
                                         dtype=_F32, device=p.device)}
            if _across_layers(shape, n_of[i]):
                return {"r": torch.zeros((), dtype=_F32, device=p.device),
                        "c": torch.zeros(shape, dtype=_F32,
                                         device=p.device)}
            return {"v": torch.zeros(shape, dtype=_F32, device=p.device)}
        inner = {"stats": tree_unflatten(
            params, iter([stats(i, p) for i, p in enumerate(flat)]))}
        if momentum:
            inner["m"] = tree_map(_zeros(torch.bfloat16), params)
        return OptState(step=_step0(params), inner=inner)

    @torch.no_grad()
    def update(grads, state, params, lr, gnorm=None, mesh=None, specs=None):
        flat_p = tree_leaves(params)
        flat_st = _flatten_upto(state.inner["stats"], params)
        flat_m = tree_leaves(state.inner["m"]) if momentum \
            else [None] * len(flat_p)
        grad_of, gn = _grads_f32(_flatten_upto(grads, params), clip_norm,
                                 gnorm)
        t = state.step + 1
        beta2 = 1.0 - (t.to(_F32) + 1.0) ** (-decay)
        mesh = None if shd.is_trivial(mesh) else mesh
        specs = specs or [None] * len(flat_p)
        axes_of = [shd.split_axes(specs[i], p.ndim, mesh)
                   for i, p in enumerate(flat_p)]
        shapes = [_whole_shape(p, ax, mesh) for p, ax in zip(flat_p, axes_of)]

        def factored(g2, st, ax):
            """(vhat at the local block, the whole new r and c); ``ax``:
            the axes splitting each dimension of g2, which is consumed."""
            lead, rows, cols = ax[:-2], ax[-2], ax[-1]
            row = shd.gather_leaf(_mean_over(g2, -1, cols, mesh),
                                  lead + [rows], mesh)
            col = shd.gather_leaf(_mean_over(g2, -2, rows, mesh),
                                  lead + [cols], mesh)
            del g2
            r = beta2 * st["r"] + (1 - beta2) * row
            c = beta2 * st["c"] + (1 - beta2) * col
            rmean = torch.mean(r, dim=-1, keepdim=True)
            vhat = shd.local_block(r, lead + [rows], mesh)[..., :, None] \
                * shd.local_block(c, lead + [cols], mesh)[..., None, :]
            vhat.div_(torch.clamp(shd.local_block(rmean, lead + [()], mesh)
                                  [..., None], min=eps))
            return vhat, r, c

        def scaled(g, vhat):
            """g / sqrt(max(vhat, eps)), written over ``vhat``: a leaf's
            update holds two tensors of its size at most."""
            return torch.div(g, vhat.clamp_(min=eps).sqrt_(), out=vhat)

        for grp in _leaf_groups(params, stacks):
            sts = [flat_st[i] for i in grp]
            if _across_layers(shapes[grp[0]], len(grp)):
                # the stacked (layers, d) vector, factored as one matrix
                g = torch.stack([grad_of(i) for i in grp])
                vhat, r, c = factored(g * g + eps, {
                    "r": torch.stack([st["r"] for st in sts]),
                    "c": sts[0]["c"]}, [()] + axes_of[grp[0]])
                for j, st in enumerate(sts):
                    st["r"].copy_(r[j])
                    st["c"].copy_(c)
                us = list(torch.unbind(scaled(g, vhat)))
                del g, vhat
            else:
                us = []
                for i, st in zip(grp, sts):
                    g = grad_of(i)
                    if _is_matrix(shapes[i]):
                        vhat, r, c = factored(torch.mul(g, g).add_(eps), st,
                                              axes_of[i])
                        st["r"].copy_(r)
                        st["c"].copy_(c)
                    else:
                        vhat = beta2 * st["v"] + (1 - beta2) * shd.gather_leaf(
                            g * g + eps, specs[i], mesh)
                        st["v"].copy_(vhat)
                        vhat = shd.local_block(vhat, specs[i], mesh)
                    us.append(scaled(g, vhat))
                    del g, vhat
            # update clipping (Shazeer & Stern): RMS(u) <= 1 over the
            # stacked tensor
            if mesh is None:
                n = sum(u.numel() for u in us)
                ms = torch.mean(us[0] * us[0]) if len(us) == 1 else \
                    torch.stack([torch.sum(u * u) for u in us]).sum() / n
            else:
                n = sum(math.prod(shapes[i]) for i in grp)
                ms = C.sum_by_axes([(torch.sum(u * u),
                                     shd.leaf_axes(specs[i], mesh))
                                    for i, u in zip(grp, us)], mesh) / n
            scale = torch.clamp(torch.sqrt(ms + eps), min=1.0)
            for i, u in zip(grp, us):
                u = u.div_(scale)
                m = flat_m[i]
                if m is not None:
                    u = 0.9 * m.to(_F32) + 0.1 * u
                    m.copy_(u)                           # bf16 momentum
                _apply(flat_p[i], u, lr, weight_decay)
            del us
        return params, OptState(step=t, inner=state.inner), {"grad_norm": gn}

    return Optimizer("adafactor", init, update)


# ---------------------------------------------------------------------------
# Lion
# ---------------------------------------------------------------------------

def lion(b1: float = 0.9, b2: float = 0.99, weight_decay: float = 0.1,
         clip_norm: Optional[float] = 1.0) -> Optimizer:
    def init(params, mesh=None, specs=None):
        return OptState(step=_step0(params),
                        inner={"m": tree_map(_zeros(), params)})

    @torch.no_grad()
    def update(grads, state, params, lr, gnorm=None, mesh=None, specs=None):
        flat_p = tree_leaves(params)
        flat_m = tree_leaves(state.inner["m"])
        grad_of, gn = _grads_f32(_flatten_upto(grads, params), clip_norm,
                                 gnorm)
        for i, (p, m) in enumerate(zip(flat_p, flat_m)):
            g = grad_of(i)
            u = torch.sign(b1 * m + (1 - b1) * g)
            _apply(p, u, lr, weight_decay)
            m.mul_(b2).add_((1 - b2) * g)
        return (params, OptState(step=state.step + 1, inner=state.inner),
                {"grad_norm": gn})

    return Optimizer("lion", init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    if name == "lion":
        return lion(**kw)
    raise ValueError(f"unknown optimizer {name!r}")
