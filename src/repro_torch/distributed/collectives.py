"""The collectives of the mesh executor: autograd-aware redistributions of
local tensors over the axes of a ``DeviceMesh``.

Every rank holds local shards of plain tensors; these functions sit where
the sharding rules split a dimension.  The gradient convention is
Megatron's: a tensor replicated over ``model`` carries, on every ``model``
rank, the whole gradient of the rank's loss, and the losses of the data
ranks add up to the global loss (``launch.steps``).  So:

- ``copy_to(x, axes)``: the identity forward; the backward sums the
  gradient over ``axes`` (a replicated tensor entering a region whose
  ranks each use a part of it);
- ``reduce_from(x, axes)``: sums partial results over ``axes``; the
  backward is the identity (a row-split weight's partial output leaving
  the region);
- ``scatter(x, dim, axes)`` / ``gather(x, dim, axes)``: take this rank's
  part of a replicated tensor / all-gather the parts into a replicated
  one; each is the other's backward;
- ``scatter_sum(x, dim, axes)``: sums partial results over ``axes``,
  this rank keeping its part along ``dim`` (a reduce-scatter); the
  backward all-gathers the gradient (a row-split weight's partial output
  entering a region split along ``dim``);
- ``all_gather_sum(x, dim, axes)``: all-gather whose backward
  reduce-scatters (sums) the gradient back to the part: FSDP's weights,
  and K/V under sequence parallelism, whose consumers each hold a
  different part of the loss;
- ``all_reduce_sum(x, axes)``: a sum whose backward is a sum too (terms
  of the loss split over the data ranks);
- ``all_to_all(x, axes)``: chunk i of dim 0 to rank i of the group (the
  expert-parallel dispatch); its backward is the same exchange.

Serving's forward-only exchanges: ``move_split`` (a tensor split on one
dimension to split on another, one all-to-all: a prefill's recurrent
state from heads to its key dimension), ``heads_to_seq`` (K/V split by
heads to split by sequence: a prefill's cache laid out by
``sharding.cache_shardings``) and ``lse_merge`` (per-rank partial reads of
a sequence-split cache merged by log-sum-exp in a fixed rank order).
``ordered_sum`` is the same fixed-order sum for the optimizer's
statistics on shards.

On no mesh, or axes of size 1, each is the identity.  Several axes form
one group, row-major in the mesh's order (``("data", "model")``: the
first outermost), built once per mesh with ``dist.new_group`` on every
rank in the same order.

Gloo (ranks sharing one card) moves CUDA tensors through host memory.
Where it refuses a collective on a CUDA tensor, the call is staged
through pinned host memory here: ``STAGED`` names each such collective.
Gloo sums bf16 in f32 here, and moves bf16 bits as f16.  Under the
``fake`` backend (``launch.dryrun``) the calls take ``meta`` tensors and
move nothing.  Every call runs inside the profiler range
``COLLECTIVE_RANGE`` and is counted in ``STATS``: calls, payload bytes
(the input's) and ``result_bytes``, the reference dry run's convention
(``repro.launch.roofline.collective_bytes``: the gathered output of an
all-gather, the input of a reduce-scatter, else the result), per kind;
``HLO_KIND`` maps the kinds to the reference's names.  ``LISTENERS`` are
called with (kind, input, output) on every call (the dry run's op
recorder).  The groups built for several axes are cached per mesh and
world (``clear_groups`` drops them).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shd

#: profiler range of every collective of the executor
COLLECTIVE_RANGE = "mesh.collective"
#: {kind: {"count": calls, "bytes": payload bytes}} since ``reset_stats``
STATS: dict = {}
#: the collective kinds staged through host memory (gloo on CUDA tensors)
STAGED: set = set()

#: the reference's HLO opcode of each kind
HLO_KIND = {"all_gather": "all-gather", "all_reduce": "all-reduce",
            "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}
#: callables ``fn(kind, input, output)`` told of every collective
LISTENERS: list = []

_GROUPS: dict = {}


def reset_stats() -> None:
    STATS.clear()


def clear_groups() -> None:
    """Forget the cached multi-axis groups (their process group is gone)."""
    _GROUPS.clear()


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _live(axes, mesh) -> Tuple[str, ...]:
    """The axes of ``axes`` of size > 1 on ``mesh``."""
    sizes = shd.mesh_shape(mesh)
    return tuple(a for a in _axes(axes) if sizes.get(a, 1) > 1)


def group_of(axes, mesh=None):
    """(process group, size) of ``axes`` on ``mesh`` (the ambient mesh by
    default); (None, 1) when they span one rank."""
    mesh = shd.ambient_mesh() if mesh is None else mesh
    axes = _live(axes, mesh)
    if not axes:
        return None, 1
    size = math.prod(shd.mesh_shape(mesh)[a] for a in axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0]), size
    names = list(mesh.mesh_dim_names)
    if [names.index(a) for a in axes] != sorted(names.index(a)
                                                for a in axes):
        raise ValueError(f"axes {axes} out of the mesh's order {names}")
    key = (id(mesh), axes)
    if key in _GROUPS and _GROUPS[key][2] is not dist.group.WORLD:
        del _GROUPS[key]               # built in a world since destroyed
    if key not in _GROUPS:
        perm = [i for i, n in enumerate(names) if n not in axes] \
            + [names.index(a) for a in axes]
        rows = mesh.mesh.permute(perm).reshape(-1, size).tolist()
        me, mine = dist.get_rank(), None
        for row in rows:                     # every rank, in one order
            g = dist.new_group(row)
            if me in row:
                mine = g
        _GROUPS[key] = (mesh, mine, dist.group.WORLD)
    return _GROUPS[key][1], size


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def result_bytes(kind: str, inp: torch.Tensor, out: torch.Tensor) -> int:
    """A call's bytes by the reference's convention: a reduce-scatter's
    input (= output × group), else its result."""
    return _nbytes(inp if kind == "reduce_scatter" else out)


def _count(kind: str, inp: torch.Tensor, out: torch.Tensor) -> None:
    s = STATS.setdefault(kind, {"count": 0, "bytes": 0, "result_bytes": 0})
    s["count"] += 1
    s["bytes"] += _nbytes(inp)
    s["result_bytes"] += result_bytes(kind, inp, out)
    for fn in LISTENERS:
        fn(kind, inp, out)


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=True)
    return h.copy_(t)


def _run(kind: str, fn, out: torch.Tensor, inp: torch.Tensor, group,
         reduces: bool) -> torch.Tensor:
    """``fn(out, inp, group)``, counted, with gloo's limits worked around:
    bf16 summed in f32 or moved as f16 bits.  Returns ``out``."""
    _count(kind, inp, out)
    with torch.profiler.record_function(COLLECTIVE_RANGE):
        if _gloo(group) and inp.dtype == torch.bfloat16:
            if reduces:
                o32 = out.float()
                _dispatch(kind, fn, o32, inp.float(), group)
                return out.copy_(o32)
            _dispatch(kind, fn, out.view(torch.float16),
                      inp.view(torch.float16), group)
            return out
        _dispatch(kind, fn, out, inp, group)
        return out


def _dispatch(kind: str, fn, out, inp, group) -> None:
    """A CUDA call that gloo refuses is staged through pinned host memory
    (and every later one of its kind)."""
    if out.device.type == "cuda" and _gloo(group):
        if kind not in STAGED:
            try:
                fn(out, inp, group)
                return
            except RuntimeError:
                STAGED.add(kind)
        h_out = torch.empty(out.shape, dtype=out.dtype, device="cpu",
                            pin_memory=True)
        fn(h_out, _host(inp), group)
        out.copy_(h_out)
        return
    fn(out, inp, group)


# ---------------------------------------------------------------------------
# raw collectives (no autograd)
# ---------------------------------------------------------------------------

def _all_reduce_fn(op):
    def fn(out, inp, group):
        if out.data_ptr() != inp.data_ptr():
            out.copy_(inp)
        dist.all_reduce(out, op=op, group=group)
    return fn


def all_reduce(t: torch.Tensor, axes, op: str = "sum",
               mesh=None) -> torch.Tensor:
    """A new tensor: ``t`` summed (or maxed, ``op="max"``) over ``axes``."""
    group, n = group_of(axes, mesh)
    if n == 1:
        return t
    rop = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    t = t.contiguous()
    return _run("all_reduce", _all_reduce_fn(rop), t.clone(), t, group,
                reduces=True)


_gather_base = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_scatter_base = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _all_gather0(out, inp, group):
    _gather_base(out, inp, group=group)


def _reduce_scatter0(out, inp, group):
    try:
        _scatter_base(out, inp, group=group)
    except RuntimeError:
        if inp.device.type == "cuda":
            raise
        # a gloo without reduce_scatter: all-reduce, then this rank's part
        full = inp.clone()
        dist.all_reduce(full, group=group)
        r = dist.get_rank(group)
        out.copy_(full[r * out.shape[0]:(r + 1) * out.shape[0]])


def all_gather(t: torch.Tensor, dim: int, axes, mesh=None) -> torch.Tensor:
    """The parts of ``t`` of every rank of ``axes``, concatenated along
    ``dim`` in group order."""
    group, n = group_of(axes, mesh)
    if n == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + x.shape[1:])
    _run("all_gather", _all_gather0, out, x, group, reduces=False)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, dim: int, axes,
                   mesh=None) -> torch.Tensor:
    """``t`` summed over ``axes``; this rank keeps its part along
    ``dim``."""
    group, n = group_of(axes, mesh)
    if n == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + x.shape[1:])
    _run("reduce_scatter", _reduce_scatter0, out, x, group, reduces=True)
    return out.movedim(0, dim)


def _all_to_all0(out, inp, group):
    dist.all_to_all_single(out, inp, group=group)


def all_to_all_raw(t: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    group, n = group_of(axes, mesh)
    if n == 1:
        return t
    t = t.contiguous()
    out = torch.empty_like(t)
    return _run("all_to_all", _all_to_all0, out, t, group, reduces=False)


def move_split(t: torch.Tensor, src: int, dst: int, axes="model",
               mesh=None) -> torch.Tensor:
    """``t`` split over ``axes`` on dimension ``src`` (rank i holds the
    i-th part) -> split on ``dst`` instead (whole on ``src``), in one
    all-to-all.  Forward only (serving)."""
    group, n = group_of(axes, mesh)
    if n == 1:
        return t
    x = t.movedim((dst, src), (0, 1))
    D, h = x.shape[:2]
    x = x.reshape((n, D // n) + x.shape[1:])
    out = all_to_all_raw(x, axes, mesh=mesh)   # out[i]: rank i's part
    out = out.transpose(0, 1).reshape((D // n, n * h) + x.shape[3:])
    return out.movedim((0, 1), (dst, src))


def heads_to_seq(t: torch.Tensor, axes="model", mesh=None) -> torch.Tensor:
    """K or V (B, S, KV_loc, D) split by heads over ``axes`` (rank i holds
    heads i·KV_loc on, every position) -> (B, S/n, n·KV_loc, D): every
    head of this rank's part of the positions (rank i the i-th S/n), in
    one all-to-all.  Forward only (serving)."""
    return move_split(t, 2, 1, axes, mesh)


def lse_merge(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor, axes,
              mesh=None) -> torch.Tensor:
    """The normalized read of per-rank partial softmax reads over
    ``axes``: each rank's running max ``m`` (−inf where it saw no key),
    sum of exponentials ``l`` (0 there) and unnormalized output ``o``
    (``m``'s shape + (Dv,)), f32.  One all-gather of the packed partials,
    then Σ_r o_r·e^(m_r − M) / Σ_r l_r·e^(m_r − M) with M = max_r m_r,
    summed in the group's rank order: every rank forms the same bits, and
    no float is reduced in an order the transport picks.  Forward only."""
    packed = torch.cat([o, m[..., None], l[..., None]], dim=-1)
    return _lse_combine(all_gather(packed[None], 0, axes, mesh=mesh))


def ordered_sum(t: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``t`` summed over ``axes`` in the group's rank order: one
    all-gather, then the parts added from rank 0 up, so every rank forms
    the same bits (a float ``all_reduce`` lets the transport pick the
    order).  Forward only."""
    if not _live(axes, shd.ambient_mesh() if mesh is None else mesh):
        return t
    parts = all_gather(t[None], 0, axes, mesh=mesh)
    out = parts[0]
    for r in range(1, parts.shape[0]):
        out = out + parts[r]
    return out


def sum_by_axes(parts: list, mesh=None) -> torch.Tensor:
    """The sum of the scalars ``parts``, [(value, the axes its leaf is
    split over)]: the values of one set of axes added over those axes in
    rank order (``ordered_sum``; a replicated leaf's, axes (), counted
    once), the sets added in sorted order."""
    by_axes: dict = {}
    for v, axes in parts:
        by_axes.setdefault(tuple(axes), []).append(v)
    total = None
    for axes in sorted(by_axes):
        s = ordered_sum(torch.stack(by_axes[axes]).sum(), axes, mesh)
        total = s if total is None else total + s
    return total


def _lse_combine(parts: torch.Tensor) -> torch.Tensor:
    """``lse_merge``'s arithmetic on the gathered partials (n, ..., Dv +
    2): o, then m, then l on the last dimension, rank r at index r."""
    ms, ls, os_ = parts[..., -2], parts[..., -1], parts[..., :-2]
    M = torch.amax(ms, dim=0)
    scale = torch.exp(ms - M)                   # e^(−inf) = 0: no key seen
    num, den = os_[0] * scale[0][..., None], ls[0] * scale[0]
    for r in range(1, parts.shape[0]):
        num = num + os_[r] * scale[r][..., None]
        den = den + ls[r] * scale[r]
    return num / den[..., None]


def _part(t: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    """This rank's part of ``t`` along ``dim`` over ``axes``."""
    axes = _live(axes, mesh)
    size = t.shape[dim] // shd._axis_size(mesh, axes)
    return t.narrow(dim, shd._index_over(mesh, axes) * size, size)


# ---------------------------------------------------------------------------
# autograd-aware redistributions (each keeps its mesh for the backward,
# which autograd may run on another thread, outside ``use_mesh``)
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axes, mesh=ctx.mesh), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return all_reduce(x, axes, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return all_reduce(x, axes, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axes, mesh=ctx.mesh), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axes, mesh):
        ctx.dim, ctx.axes, ctx.mesh = dim, axes, mesh
        return _part(x, dim, axes, mesh).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (all_gather(g, ctx.dim, ctx.axes, mesh=ctx.mesh).contiguous(),
                None, None, None)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axes, mesh):
        ctx.dim, ctx.axes, ctx.mesh = dim, axes, mesh
        return all_gather(x, dim, axes, mesh=mesh).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_part(g, ctx.dim, ctx.axes, ctx.mesh).contiguous(),
                None, None, None)


class _AllGatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axes, mesh):
        ctx.dim, ctx.axes, ctx.mesh = dim, axes, mesh
        return all_gather(x, dim, axes, mesh=mesh).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g, ctx.dim, ctx.axes,
                               mesh=ctx.mesh).contiguous(), None, None, None)


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axes, mesh):
        ctx.dim, ctx.axes, ctx.mesh = dim, axes, mesh
        return reduce_scatter(x, dim, axes, mesh=mesh).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (all_gather(g, ctx.dim, ctx.axes, mesh=ctx.mesh).contiguous(),
                None, None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return all_to_all_raw(x, axes, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_raw(g, ctx.axes, mesh=ctx.mesh), None, None


def _apply(fn, x, *args, axes):
    """``fn`` on the ambient mesh, or ``x`` when ``axes`` span one rank."""
    mesh = shd.ambient_mesh()
    if not _live(axes, mesh):
        return x
    return fn.apply(x, *args, _axes(axes), mesh)


def copy_to(x: torch.Tensor, axes) -> torch.Tensor:
    return _apply(_CopyTo, x, axes=axes)


def reduce_from(x: torch.Tensor, axes) -> torch.Tensor:
    return _apply(_ReduceFrom, x, axes=axes)


def all_reduce_sum(x: torch.Tensor, axes) -> torch.Tensor:
    return _apply(_AllReduceSum, x, axes=axes)


def scatter(x: torch.Tensor, dim: int, axes) -> torch.Tensor:
    return _apply(_Scatter, x, dim, axes=axes)


def gather(x: torch.Tensor, dim: int, axes) -> torch.Tensor:
    return _apply(_Gather, x, dim, axes=axes)


def scatter_sum(x: torch.Tensor, dim: int, axes) -> torch.Tensor:
    return _apply(_ScatterSum, x, dim, axes=axes)


def all_gather_sum(x: torch.Tensor, dim: int, axes) -> torch.Tensor:
    return _apply(_AllGatherSum, x, dim, axes=axes)


def all_to_all(x: torch.Tensor, axes) -> torch.Tensor:
    return _apply(_AllToAll, x, axes=axes)


def axes_size(axes, mesh: Optional[object] = None) -> int:
    """The number of ranks ``axes`` span on ``mesh`` (ambient default)."""
    mesh = shd.ambient_mesh() if mesh is None else mesh
    return shd._axis_size(mesh, _live(axes, mesh))
