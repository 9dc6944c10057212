"""Meshes and sharding rules of the port (port of
``repro.distributed.sharding``).

Physical mesh axes, as in the reference:

- ``pod``   (multi-pod only): pure data parallelism across pods;
- ``data``  : data parallelism; also hosts FSDP (ZeRO-3) param sharding;
- ``model`` : tensor / expert parallelism (heads, FFN width, vocabulary,
              experts), and sequence parallelism for attention whose heads
              do not divide it.

The counterpart of the reference's ``jax.sharding.Mesh`` is a
``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names`` are
those axes.  The rules read only the axis sizes, so they also take a plain
``{name: size}`` dict: a spec for the (16, 16) production mesh needs no 256
ranks.

**Specs.**  A spec is a tuple with one entry per tensor dimension: ``None``,
an axis name, or a tuple of axis names (a dimension split over several
axes, row-major: the first axis outermost) — the entries of the
reference's ``PartitionSpec``.  ``()`` is replicated (``P()``).  The rules
are the reference's, name and shape based: ``param_pspec`` reads the
parameter's path (``stack/scanned/0/1/mixer/wq``) and shape and falls back
to replication for any dimension its axis does not divide.  The port keeps
one tensor a layer (the reference's unrolled layout), so no port leaf has
a leading layers dimension: the port's spec of a per-layer leaf is the
reference's spec of the stacked leaf with its first entry dropped.  Its
``_is_stacked`` reads the port's paths (whisper's ``xattn`` is a list of
per-layer dicts here, not a vmapped stack).  ``cache_shardings`` decides a
per-layer cache leaf of a ``scanned`` section as the reference decides the
stacked leaf it belongs to (the stack's bytes, its leading dimension) and
drops that entry.

**The sweep's data axis** (``data_axes``, ``data_size``, ``shard_index``,
``data_parallel_mesh``): the sweep engine's panels split over the
``pod``/``data`` ranks, row-major with ``pod`` outer; partial results
are summed by ``collectives.all_reduce`` over those axes; inputs are
replicated and every rank returns the full result.

**Local shards.**  ``shard_tree(tree, specs, mesh)`` gives this rank's
part of each leaf; ``placements(spec, mesh)`` the DTensor placements of a
spec (a dimension split over two axes is ``Shard`` on both mesh
dimensions, which DTensor lays out row-major, as JAX does).  A decode
cache: ``shard_cache`` lays a whole one out by ``cache_shardings`` (its
dicts carrying their specs, as a prefill on the mesh returns them),
``gather_cache`` gathers it back, ``local_range`` gives a rank's first
position (or ring slot) and count along a split dimension.

**Batch rows.**  A batch goes over the data axes where they divide it,
else over ``data`` alone where it divides it (the ``pod`` ranks then hold
the same rows), else it is whole on every rank (``batch_pspec``;
``row_axes``): the reference's ``batch_shardings``, for serving and
training alike.  ``use_rows`` tells the model code which (``batch_axes``:
the MoE's global capacity and expert-parallel token slices, the landmark
draws' rows).

**The ambient mesh.**  ``use_mesh(mesh)`` sets the mesh the model code runs
under (a ``contextvars`` variable of this module): ``ambient_axis_size``,
``axis_index`` and ``constrain`` read it.  Outside it, or on a mesh of one
device, every model function takes its single-device path unchanged.
``mesh_view(params, specs)`` lays the params out for the model code:
each dict becomes a ``MeshParams``, a dict that carries its leaves' specs,
so ``split(params, key, dim)`` tells whether a weight's dimension is split
over ``model``; ``materialize`` all-gathers the FSDP (``data``)
dimensions of a block's weights just before use (``collectives``).

A sharded sweep or train step runs under any launcher that sets up a
process group — ``torchrun --nproc-per-node 4`` or
``torch.multiprocessing.spawn`` with ``dist.init_process_group("gloo",
...)`` — then ``data_parallel_mesh()`` or ``launch.mesh.make_mesh`` gives
the mesh.  Gloo moves CUDA tensors too (through host memory), which lets
several ranks share one card.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import TensorSpec

DATA_DIMS = ("pod", "data")

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)
_ROWS: contextvars.ContextVar = contextvars.ContextVar("repro_torch_rows",
                                                       default=None)


# ---------------------------------------------------------------------------
# mesh shapes
# ---------------------------------------------------------------------------

def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, a dict, or None ({})."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names or (), mesh.shape))


def is_trivial(mesh) -> bool:
    """No mesh, or a mesh of one device: the single-device path."""
    size = 1
    for v in mesh_shape(mesh).values():
        size *= v
    return size <= 1


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, (tuple, list)):
        out = 1
        for n in name:
            out *= _axis_size(mesh, n)
        return out
    return mesh_shape(mesh).get(name, 1)


def _fit(dim: int, axis, mesh):
    """``axis`` if ``dim`` is divisible by its mesh size (> 1), else None."""
    return axis if axis is not None and dim % _axis_size(mesh, axis) == 0 \
        and _axis_size(mesh, axis) > 1 else None


def data_axes(mesh) -> Tuple[str, ...]:
    """The pure data-parallel axes of ``mesh``, outermost first: ('pod',
    'data'), ('data',), ('pod',) or () (also for ``None``)."""
    names = mesh_shape(mesh)
    return tuple(a for a in DATA_DIMS if a in names)


def _dim_size(mesh, name: str) -> int:
    return mesh_shape(mesh)[name]


def data_size(mesh) -> int:
    """Data-parallel width of ``mesh``: 1 for None and trivial meshes."""
    return _axis_size(mesh, data_axes(mesh))


def _coords(mesh) -> dict:
    """{axis name: this rank's coordinate} on a ``DeviceMesh``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not part of the mesh")
    return dict(zip(mesh.mesh_dim_names, (int(c) for c in coord)))


def _index_over(mesh, axes) -> int:
    """This rank's row-major coordinate over ``axes`` (first outermost)."""
    if isinstance(axes, str):
        axes = (axes,)
    coords = _coords(mesh)
    k = 0
    for a in axes:
        if a in coords:
            k = k * _dim_size(mesh, a) + coords[a]
    return k


def shard_index(mesh) -> int:
    """This rank's shard: its coordinate over the data dims, row-major
    with ``pod`` outer (0 on a trivial mesh)."""
    coord = mesh.get_coordinate() if mesh is not None else None
    if coord is None:
        if data_size(mesh) > 1:
            raise RuntimeError("this rank is not part of the mesh")
        return 0
    return _index_over(mesh, data_axes(mesh))


def data_parallel_mesh(device_type: str = "cuda"):
    """A 1-D ('data',) mesh over every rank of the default process group,
    on ``device_type`` — the mesh the sweep engine shards over.  None when
    ``torch.distributed`` is not initialized or the world has one rank:
    every ``mesh=`` consumer then takes the single-device route."""
    if not dist.is_available() or not dist.is_initialized():
        return None
    world = dist.get_world_size()
    if world <= 1:
        return None
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (world,), mesh_dim_names=("data",))


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

class Spec(tuple):
    """A spec: a tuple with one entry per tensor dimension (a leaf of a
    spec tree, which a plain tuple of a params tree is not)."""

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, Spec)) or (
        hasattr(x, "shape") and not isinstance(x, (dict, list)))


def _children(tree):
    """(key, child) pairs in the port's tree order (sorted dict keys,
    sequences in order, a NamedTuple by field)."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if hasattr(tree, "_fields"):
        return [(f, getattr(tree, f)) for f in tree._fields]
    return [(str(i), v) for i, v in enumerate(tree)]


def _rebuild(tree, values):
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), values))
    if hasattr(tree, "_fields"):
        return type(tree)(*values)
    return type(tree)(values)


def map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``; ``path`` is
    the tuple of keys down to it."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(path, tree)
    return _rebuild(tree, [map_with_path(fn, c, path + (k,))
                           for k, c in _children(tree)])


def leaves_with_path(tree, path: Tuple[str, ...] = ()) -> list:
    """[(path, leaf)] in tree order."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [(path, tree)]
    return [x for k, c in _children(tree)
            for x in leaves_with_path(c, path + (k,))]


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

_REPLICATED_KEYS = ("norm", "scale", "router", "q_norm", "k_norm", "kv_norm",
                    "a_param", "conv", "gates", "offset")


def _is_stacked(parts) -> bool:
    """Does this leaf carry a leading layers dim?  The reference's rule on
    the port's paths: under ``scanned``, one numeric is a stack of layers
    and two are one layer (the port's ``stack/scanned/<rep>/<slot>/...``
    is always the latter).  Unlike the reference, ``xattn`` is not
    stacked: the port keeps whisper's cross-attention a list of per-layer
    dicts."""
    if "scanned" not in parts:
        return False
    i = parts.index("scanned")
    numerics = 0
    for p in parts[i + 1:]:
        if p.lstrip("-").isdigit():
            numerics += 1
        else:
            break
    return numerics <= 1


def param_pspec(path: str, shape: Tuple[int, ...], mesh,
                fsdp: bool = False, moe_ep2d: bool = False) -> tuple:
    """The spec of one parameter leaf (the reference's rules).

    ``path`` is '/'-joined keys.  ``moe_ep2d`` spreads expert banks over
    ('data','model') — the expert-parallel layout (``moe_impl=
    "shard_map"``)."""
    parts = path.strip("/").split("/")
    key = parts[-1]
    nd = len(shape)
    off = 1 if (_is_stacked(parts) and nd >= 2) else 0   # leading layer dim

    def spec(*axes):
        full = [None] * nd
        for i, ax in enumerate(axes):
            full[off + i] = _fit(shape[off + i], ax, mesh)
        return Spec(full)

    fs = "data" if fsdp else None                 # ZeRO-3 axis

    # ---- norms / small vectors -------------------------------------------
    if any(k in key for k in _REPLICATED_KEYS) and nd - off <= 2:
        return Spec((None,) * nd)

    # ---- embeddings: vocab -> model --------------------------------------
    if key == "embedding":                        # (V, d)
        return spec("model", None)
    if key == "unembed":                          # (d, V)
        return spec(None, "model")
    if key == "frontend_proj":                    # (d_front, d)
        return spec(None, "model")

    # ---- MoE expert banks -------------------------------------------------
    if "moe" in parts and key in ("wi_gate", "wi_up", "wo") \
            and "shared" not in parts and nd - off == 3:
        # (E, d, ff) / (E, ff, d): experts -> model (EP); when the expert
        # count does not divide the axis, TP inside each expert on ff
        if moe_ep2d and _fit(shape[off], ("data", "model"), mesh):
            return spec(("data", "model"), None, None)
        if _fit(shape[off], "model", mesh):
            return spec("model", fs, None)
        if key == "wo":                           # (E, ff, d)
            return spec(None, "model", fs)
        return spec(None, fs, "model")            # (E, d, ff)

    # ---- attention --------------------------------------------------------
    if key == "wq" and nd - off == 3:             # (d, H, hd): heads -> model
        return spec(fs, "model", None)
    if key in ("wk", "wv") and nd - off == 3:     # (d, KV, hd)
        return spec(fs, "model", None)
    if key == "wo" and nd - off == 3:             # (H, hd, d)
        return spec("model", None, fs)

    # ---- MLA (deepseek) ---------------------------------------------------
    if key == "wq_a":                             # (d, q_rank)
        return spec(fs, "model")
    if key == "wq_b":                             # (q_rank, H, k)
        return spec(fs, "model", None)
    if key == "wkv_a":                            # (d, R+dr)
        return spec(fs, None)
    if key == "wkv_b":                            # (R, H, k)
        return spec(fs, "model", None)

    # ---- dense MLP --------------------------------------------------------
    if key in ("wi_gate", "wi_up") and nd - off == 2:   # (d, ff)
        return spec(fs, "model")
    if key == "wo" and nd - off == 2:                   # (ff, d)
        return spec("model", fs)

    # ---- recurrent mixers (rglru / mlstm / slstm) -------------------------
    if key in ("wx", "wy"):                       # rglru in/out
        return spec(fs, "model") if key == "wx" else spec("model", fs)
    if key in ("wqkv", "wi", "wf", "wz", "wout", "wproj", "wup", "wdown"):
        full = [None] * nd
        if nd - off >= 2:
            widest = max(range(off, nd), key=lambda i: shape[i])
            full[widest] = _fit(shape[widest], "model", mesh)
        return Spec(full)

    # ---- fallback: shard the largest dim over model if it fits ------------
    if nd - off >= 2 and max(shape[off:]) >= 1024:
        full = [None] * nd
        widest = max(range(off, nd), key=lambda i: shape[i])
        full[widest] = _fit(shape[widest], "model", mesh)
        return Spec(full)
    return Spec((None,) * nd)


def param_shardings(params, mesh, fsdp: bool = False,
                    moe_ep2d: bool = False):
    """The spec tree of ``params`` (tensors of any device, meta too)."""
    return map_with_path(
        lambda path, leaf: param_pspec("/".join(path), tuple(leaf.shape),
                                       mesh, fsdp=fsdp, moe_ep2d=moe_ep2d),
        params)


# ---------------------------------------------------------------------------
# batch / cache rules
# ---------------------------------------------------------------------------

def batch_pspec(shape: Tuple[int, ...], mesh,
                seq_axis: Optional[int] = None) -> tuple:
    """Shard the batch dim over as much of (pod, data) as divides it; for
    an unshardable batch (e.g. long_500k B=1) shard ``seq_axis`` over
    'data'."""
    if not shape:
        return Spec()
    B = shape[0]
    dp = data_axes(mesh)
    sizes = mesh_shape(mesh)
    full = [None] * len(shape)
    if dp and B % _axis_size(mesh, dp) == 0:
        full[0] = dp
    elif "data" in sizes and B % sizes["data"] == 0 and sizes["data"] > 1:
        full[0] = "data"
    elif seq_axis is not None and len(shape) > seq_axis \
            and shape[seq_axis] % _axis_size(mesh, "data") == 0:
        full[seq_axis] = "data"
    return Spec(full)


def batch_shardings(batch, mesh):
    """Specs of a train/prefill/decode input batch dict."""
    return map_with_path(lambda _, leaf: batch_pspec(tuple(leaf.shape),
                                                     mesh), batch)


def _cache_spec(keys, shape, mesh) -> list:
    """The reference's rule for one attention-cache or landmark-factor
    leaf (``keys`` its path; recurrent states: ``state_pspec``)."""
    dp = data_axes(mesh)
    key = keys[-1] if keys else ""
    nd = len(shape)
    full = [None] * nd
    if key in ("k", "v") or "enc_kv" in keys:
        off = nd - 4                           # (B, S, KV, hd) trailing
        b, s, kvh = off, off + 1, off + 2
        if shape[b] > 1 and shape[b] % _axis_size(mesh, dp) == 0 \
                and _axis_size(mesh, dp) > 1:
            full[b] = dp
            leaf_bytes = 2
            for d in shape:
                leaf_bytes *= d
            local_bytes = leaf_bytes // _axis_size(mesh, dp)
            if _fit(shape[kvh], "model", mesh):
                full[kvh] = "model"
            elif local_bytes > 2e9 and shape[s] >= 1024 \
                    and _fit(shape[s], "model", mesh):
                full[s] = "model"
        else:
            axes = tuple(a for a in ("pod", "data", "model")
                         if a in mesh_shape(mesh))
            if shape[s] % _axis_size(mesh, axes) == 0 and shape[s] >= 1024:
                full[s] = axes
            elif _fit(shape[s], "data", mesh):
                full[s] = "data"
    elif key in ("ckv", "krope"):
        off = nd - 3                           # (B, S, R)
        b, s = off, off + 1
        if shape[b] > 1 and shape[b] % _axis_size(mesh, dp) == 0 \
                and _axis_size(mesh, dp) > 1:
            full[b] = dp
            if shape[s] >= 1024 and _fit(shape[s], "model", mesh):
                full[s] = "model"
        elif shape[s] >= 1024:
            axes = tuple(a for a in ("pod", "data", "model")
                         if a in mesh_shape(mesh))
            if shape[s] % _axis_size(mesh, axes) == 0:
                full[s] = axes
    elif key in ("k_land", "uv", "u1", "offset"):
        base_nd = {"k_land": 4, "uv": 4, "u1": 3, "offset": 2}[key]
        b = nd - base_nd                       # 1 when stacked, else 0
        if b < nd and shape[b] > 1 and _axis_size(mesh, dp) > 1 \
                and shape[b] % _axis_size(mesh, dp) == 0:
            full[b] = dp
    return full


def _is_state(keys) -> bool:
    """A recurrent state leaf (not an attention cache or landmark
    factor)."""
    key = keys[-1] if keys else ""
    return not (key in ("k", "v", "ckv", "krope", "k_land", "uv", "u1",
                        "offset") or "enc_kv" in keys)


def state_pspec(shape: Tuple[int, ...], mesh) -> tuple:
    """The port's rule for one recurrent decode-state leaf (B, ...): the
    rows over the data axes where ``batch_pspec`` splits a batch of B
    (the serving rows, ``row_axes``), and the widest of the other
    dimensions (the first of equal ones) over ``model`` when it is at
    least 128 and ``model`` divides it.  The recurrent mixers lay their
    states out by it on a mesh (``models.recurrent``).

    The reference's rule (ROADMAP C11) gives the data axes to the first
    of the first two dimensions they divide and ``model`` to the widest
    dimension of all.  On its stacked cache (reps, B, ...) the first is
    the layer reps: recurrentgemma-2b's 8 and xlstm-125m's 6 reps go over
    ``data`` there, and a batch of one puts an unstacked state's width
    on ``data``.  Here the rows are what each data rank computes, so its
    states stay on it; the values are the same."""
    nd = len(shape)
    full = [None] * nd
    rows = batch_pspec((shape[0],), mesh)[0] if nd else None
    if rows is not None and shape[0] > 1 and _axis_size(mesh, rows) > 1:
        full[0] = rows
    if nd >= 2:
        widest = max(range(1, nd), key=lambda i: shape[i])
        if shape[widest] >= 128 and _fit(shape[widest], "model", mesh):
            full[widest] = "model"
    return Spec(full)


def row_axes(batch: int, mesh) -> Tuple[str, ...]:
    """The axes (of size > 1) that split a batch of ``batch`` rows under
    ``batch_pspec``: () where the rows are whole on every rank."""
    entry = batch_pspec((batch,), mesh)[0]
    return tuple(a for a in _entry_axes(entry) if _axis_size(mesh, a) > 1)


def cache_shardings(cache, mesh):
    """Decode caches, keyed by leaf name (the reference's cache layout
    contract): k/v/enc_kv batch -> DP and KV heads -> 'model' when they
    divide it, else the sequence -> 'model' for a cache over 2e9 bytes a
    DP rank; MLA latents batch -> DP, sequence -> 'model'; landmark
    factors batch -> DP; a batch that DP does not divide puts the
    sequence on every axis it divides.  A layer of a ``scanned`` section
    is decided as the reference's stacked leaf (its reps on a leading
    axis) and that entry dropped.  Recurrent states follow the port's
    ``state_pspec`` on each layer's leaf (rows -> DP, the widest other
    dim -> 'model'), which differs from the reference's rule on its
    stacked leaf (ROADMAP C11)."""
    reps = len(cache["scanned"]) if isinstance(cache, dict) \
        and isinstance(cache.get("scanned"), list) else 0

    def one(path, leaf):
        shape = tuple(leaf.shape)
        if _is_state(path):
            return state_pspec(shape, mesh)
        if reps and path and path[0] == "scanned":
            full = _cache_spec(path, (reps,) + shape, mesh)
            return Spec(full[1:])
        return Spec(_cache_spec(path, shape, mesh))

    return map_with_path(one, cache)


def tree_shardings(tree, mesh, pspec_fn):
    """Generic: one spec per leaf from ``pspec_fn(path, shape)``."""
    return map_with_path(lambda path, leaf: pspec_fn(
        "/".join(path), tuple(leaf.shape)), tree)


def replicated(mesh) -> tuple:
    """The replicated spec (``P()``)."""
    return Spec()


# ---------------------------------------------------------------------------
# placements and local shards
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every axis a spec splits over."""
    return tuple(a for e in spec for a in _entry_axes(e))


def placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension:
    ``Shard(d)`` where tensor dim d is split over it, else ``Replicate()``.
    A dimension over two axes must name them in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_shape(mesh))
    out = [Replicate() for _ in names]
    for d, e in enumerate(spec):
        axes = [a for a in _entry_axes(e) if a in names]
        if [names.index(a) for a in axes] != sorted(
                names.index(a) for a in axes):
            raise ValueError(f"spec {spec}: axes of dim {d} out of the "
                             f"mesh's order {names}")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return out


def split_axes(spec, ndim: int, mesh) -> list:
    """The axes (of size > 1) that split each of ``ndim`` dimensions under
    ``spec``: all () without a spec or off a mesh."""
    if spec is None or is_trivial(mesh):
        return [()] * ndim
    return [tuple(a for a in _entry_axes(spec[d] if d < len(spec) else None)
                  if _axis_size(mesh, a) > 1) for d in range(ndim)]


def leaf_axes(spec, mesh) -> Tuple[str, ...]:
    """Every axis (of size > 1) that splits a leaf under ``spec``, in the
    mesh's order: the ranks whose parts of a sum over the leaf add up."""
    used = spec_axes(spec or ())
    return tuple(a for a, n in mesh_shape(mesh).items() if n > 1 and a in used)


def local_block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's part of ``t`` under ``spec`` (a view)."""
    for d, axes in enumerate(split_axes(spec, t.ndim, mesh)):
        if axes:
            n = t.shape[d] // _axis_size(mesh, axes)
            t = t.narrow(d, _index_over(mesh, axes) * n, n)
    return t


def local_shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's part of ``t`` under ``spec`` (a contiguous copy)."""
    return local_block(t, spec, mesh).clone(
        memory_format=torch.contiguous_format)


def gather_leaf(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor whose part under ``spec`` this rank's ``t`` is:
    all-gathered over the axes that split each dimension (the inverse of
    ``local_shard``)."""
    from repro_torch.distributed import collectives as C
    for d, axes in enumerate(split_axes(spec, t.ndim, mesh)):
        if axes:
            t = C.all_gather(t, d, axes, mesh=mesh)
    return t


def shard_tree(tree, specs, mesh):
    """This rank's local shards of a param or state tree; a shape-only
    leaf (``TensorSpec``) becomes its local part's."""
    flat = dict(leaves_with_path(specs)) if specs is not None else {}

    def one(path, leaf):
        spec = flat.get(path, ())
        if isinstance(leaf, torch.Tensor):
            return local_shard(leaf, spec, mesh)
        if isinstance(leaf, TensorSpec):
            return TensorSpec(tuple(
                n // _axis_size(mesh, axes) if axes else n
                for n, axes in zip(leaf.shape,
                                   split_axes(spec, len(leaf.shape), mesh))),
                leaf.dtype)
        return leaf

    return map_with_path(one, tree)


def local_range(spec, dim: int, size: int, mesh=None) -> Tuple[int, int]:
    """(first index, length) of this rank's part of dimension ``dim`` (of
    global length ``size``) under ``spec`` on ``mesh`` (the ambient mesh
    by default): (0, size) where the dimension is whole.  For a cache
    leaf split by sequence these are its first position and its count;
    for a ring, its first slot and its count of slots."""
    mesh = _MESH.get() if mesh is None else mesh
    axes = split_axes(spec, dim + 1, mesh)[dim]
    if not axes:
        return 0, size
    n = _axis_size(mesh, axes)
    return _index_over(mesh, axes) * (size // n), size // n


def shard_cache(cache, mesh):
    """This rank's shards of a whole decode cache, laid out by
    ``cache_shardings`` and carrying their specs (``mesh_view``): what a
    prefill on ``mesh`` returns and a decode step takes."""
    specs = cache_shardings(cache, mesh)
    return mesh_view(shard_tree(cache, specs, mesh), specs)


def gather_cache(cache, mesh):
    """The whole cache of a tree of local shards carrying their specs
    (``shard_cache``, a prefill's output), on every rank: each leaf
    all-gathered over the axes its spec splits."""
    def walk(tree):
        if isinstance(tree, dict):
            specs = getattr(tree, "specs", {})
            return {k: gather_leaf(v, specs[k], mesh)
                    if isinstance(v, torch.Tensor)
                    else walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            specs = getattr(tree, "specs", None)
            return tuple(gather_leaf(v, specs[i], mesh)
                         if isinstance(v, torch.Tensor) else walk(v)
                         for i, v in enumerate(tree)) \
                if specs is not None else type(tree)(walk(v) for v in tree)
        return tree
    return walk(cache)


# ---------------------------------------------------------------------------
# the ambient mesh
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def use_mesh(mesh):
    """Run the model code under ``mesh`` (None: no mesh)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def ambient_mesh():
    """The mesh of ``use_mesh``, or None."""
    return _MESH.get()


@contextlib.contextmanager
def use_rows(axes):
    """Run the model code with its batch rows split over ``axes``
    (``row_axes`` of the batch: ``()`` where it is whole on every rank).
    Outside it the rows are split over the data axes."""
    token = _ROWS.set(tuple(axes))
    try:
        yield
    finally:
        _ROWS.reset(token)


def batch_axes() -> Tuple[str, ...]:
    """The axes of the ambient mesh that split the batch rows
    (``use_rows``; the data axes by default)."""
    rows = _ROWS.get()
    return data_axes(_MESH.get()) if rows is None else rows


def mesh_active() -> bool:
    """An ambient mesh of more than one device."""
    return not is_trivial(_MESH.get())


def bind_mesh(fn):
    """``fn`` called under the ambient mesh and batch rows (``use_rows``)
    of now, wherever it runs: a block that autograd recomputes for a
    checkpoint runs on autograd's thread, outside this thread's
    ``use_mesh``.  ``fn`` itself without a mesh."""
    mesh, rows = _MESH.get(), _ROWS.get()
    if is_trivial(mesh):
        return fn

    def bound(*args, **kwargs):
        token = _ROWS.set(rows)
        try:
            with use_mesh(mesh):
                return fn(*args, **kwargs)
        finally:
            _ROWS.reset(token)
    return bound


def ambient_axis_size(name) -> int:
    """Size of a mesh axis (or the product over a tuple of axes) in the
    ambient mesh, else 1."""
    return _axis_size(_MESH.get(), name)


def axis_index(name) -> int:
    """This rank's coordinate along ``name`` (row-major over a tuple) in
    the ambient mesh; 0 where the axis is absent."""
    mesh = _MESH.get()
    if mesh is None or ambient_axis_size(name) <= 1:
        return 0
    return _index_over(mesh, name)


def constrain(x: torch.Tensor, spec, src=()) -> torch.Tensor:
    """``x`` redistributed from its layout ``src`` (default replicated) to
    ``spec``: a dimension that ``spec`` splits and ``src`` does not takes
    this rank's part (its backward all-gathers the gradient); one that
    ``src`` splits and ``spec`` does not is all-gathered (its backward
    takes this rank's part of the gradient, which the replicated
    consumers hold whole).  On no mesh, or axes of size 1, the identity."""
    from repro_torch.distributed import collectives as C
    for d in range(x.ndim):
        want = _entry_axes(spec[d] if d < len(spec) else None)
        have = _entry_axes(src[d] if d < len(src) else None)
        if want == have:
            continue
        if have and ambient_axis_size(have) > 1:
            x = C.gather(x, d, have)
        if want and ambient_axis_size(want) > 1:
            x = C.scatter(x, d, want)
    return x


# ---------------------------------------------------------------------------
# params under a mesh
# ---------------------------------------------------------------------------

class MeshParams(dict):
    """A params dict on a mesh: the local shards as values, and ``specs``,
    the spec of each tensor leaf by key.  A plain dict otherwise."""

    def __init__(self, items=(), specs=None):
        super().__init__(items)
        self.specs = dict(specs or {})


class MeshTuple(tuple):
    """A tuple of local shards on a mesh (the encoder-decoder's ``enc_kv``)
    carrying ``specs``, one per element.  A plain tuple otherwise."""

    def __new__(cls, items=(), specs=None):
        out = super().__new__(cls, items)
        out.specs = tuple(specs or ())
        return out


def mesh_view(params, specs):
    """``params`` (local shards) with every dict a ``MeshParams`` holding
    its leaves' specs from the spec tree ``specs``, and every tuple of
    tensors a ``MeshTuple``."""
    if isinstance(params, dict):
        return MeshParams(
            {k: mesh_view(v, specs[k]) for k, v in params.items()},
            {k: specs[k] for k, v in params.items()
             if isinstance(v, torch.Tensor)})
    if isinstance(params, (list, tuple)):
        items = [mesh_view(v, s) for v, s in zip(params, specs)]
        if isinstance(params, tuple) and all(
                isinstance(v, torch.Tensor) for v in params):
            return MeshTuple(items, specs)
        return type(params)(items)
    return params


def split_dim(params, key: str) -> Optional[int]:
    """The dimension of ``params[key]`` split over ``model`` (of size
    > 1), or None (also for a plain dict)."""
    specs = getattr(params, "specs", None)
    if not specs or key not in specs or ambient_axis_size("model") <= 1:
        return None
    d = _model_dim(specs[key])
    return None if d < 0 else d


def split(params, key: str, dim: int, axis: str = "model") -> bool:
    """Is dimension ``dim`` of ``params[key]`` split over ``axis`` (of size
    > 1)?  False for a plain dict."""
    specs = getattr(params, "specs", None)
    if not specs or key not in specs or ambient_axis_size(axis) <= 1:
        return False
    spec = specs[key]
    return dim < len(spec) and axis in _entry_axes(spec[dim])


def _fsdp_dims(spec) -> list:
    return [d for d, e in enumerate(spec) if e == "data"]


def materialize(params, keys: Optional[Sequence[str]] = None):
    """The weights of a ``MeshParams`` (its ``keys``, all by default) with
    their FSDP dimensions (a ``data`` entry) all-gathered over ``data``,
    at any depth; the gradient of each is reduce-scattered back to the
    shard.  A plain dict, or a mesh without ``data``, comes back as it
    is."""
    if not isinstance(params, MeshParams):
        return params
    from repro_torch.distributed import collectives as C
    gather = ambient_axis_size("data") > 1
    items, specs = {}, {}
    for k in (params if keys is None else [k for k in keys if k in params]):
        v = params[k]
        if isinstance(v, torch.Tensor):
            spec = params.specs[k]
            dims = _fsdp_dims(spec) if gather else []
            for d in dims:
                v = C.all_gather_sum(v, d, "data")
            items[k] = v
            specs[k] = Spec(None if d in dims else e
                            for d, e in enumerate(spec))
        else:
            items[k] = materialize(v)
    return MeshParams(items, specs)


def tp_local(params):
    """A ``MeshParams`` for a tensor-parallel region: the leaves split
    over ``model`` as they are, every other leaf through
    ``collectives.copy_to`` (its gradient, partial on each ``model`` rank
    inside the region, is summed over ``model``)."""
    from repro_torch.distributed import collectives as C
    items, specs = {}, getattr(params, "specs", {})
    for k, v in params.items():
        if isinstance(v, torch.Tensor):
            items[k] = v if _model_dim(specs.get(k)) >= 0 \
                else C.copy_to(v, "model")
        else:
            items[k] = tp_local(v)
    return MeshParams(items, specs)


def _model_dim(spec) -> int:
    for d, e in enumerate(spec or ()):
        if "model" in _entry_axes(e):
            return d
    return -1
