"""The data-parallel mesh of the sweep engine (port of the part of
``repro.distributed.sharding`` that ``repro.core.sweep`` uses).

The counterpart of the reference's ``jax.sharding.Mesh`` is a
``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names`` hold
``"data"`` and optionally ``"pod"`` (pure data parallelism; a ``"model"``
dim is allowed and ignored by the sweep).  Rules:

- the data-parallel width (``data_size``) is the product of the sizes of
  the ``pod`` and ``data`` dims that are present: 1 for ``None`` and for a
  mesh without them, which every ``mesh=`` consumer treats as the
  single-device route;
- a rank's shard is its coordinate over those dims in row-major order,
  ``pod`` outer (``shard_index``) — how ``shard_map(in_specs=P(("pod",
  "data")))`` splits the panel starts;
- partial results are summed with ``dist.all_reduce(SUM)`` over each data
  dim's group in turn, ``data`` then ``pod`` (``all_reduce_sum``) — the
  reference's ``psum`` over both axes;
- inputs are replicated and every rank returns the full result: each rank
  must be handed the same data and the same random draws.

A sharded sweep runs under any launcher that sets up a process group —
``torchrun --nproc-per-node 4`` or ``torch.multiprocessing.spawn`` with
``dist.init_process_group("gloo", ...)`` on the CPU — then
``data_parallel_mesh()`` gives the mesh.  Gloo all-reduces CUDA tensors
too (through host memory), which lets several ranks share one card.

The model-stack rules of the reference module (``param_pspec``,
``batch_pspec``, ``cache_shardings`` and the rest) are not ported.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

DATA_DIMS = ("pod", "data")


def data_axes(mesh) -> Tuple[str, ...]:
    """The pure data-parallel dims of ``mesh``, outermost first: ('pod',
    'data'), ('data',), ('pod',) or () (also for ``None``)."""
    if mesh is None:
        return ()
    names = tuple(mesh.mesh_dim_names or ())
    return tuple(a for a in DATA_DIMS if a in names)


def _dim_size(mesh, name: str) -> int:
    return int(mesh.size(tuple(mesh.mesh_dim_names).index(name)))


def data_size(mesh) -> int:
    """Data-parallel width of ``mesh``: 1 for None and trivial meshes."""
    out = 1
    for a in data_axes(mesh):
        out *= _dim_size(mesh, a)
    return out


def shard_index(mesh) -> int:
    """This rank's shard: its coordinate over the data dims, row-major
    with ``pod`` outer (0 on a trivial mesh)."""
    coord = mesh.get_coordinate() if mesh is not None else None
    if coord is None:
        if data_size(mesh) > 1:
            raise RuntimeError("this rank is not part of the mesh")
        return 0
    names = tuple(mesh.mesh_dim_names)
    k = 0
    for a in data_axes(mesh):
        k = k * _dim_size(mesh, a) + int(coord[names.index(a)])
    return k


def all_reduce_sum(tensors: Sequence[torch.Tensor], mesh) -> list:
    """Sum each tensor (one dtype, e.g. the f32 carries of a sweep) over the
    data dims of ``mesh``: ``data``, then ``pod``.  The tensors are packed
    into one buffer, so a sweep costs one all-reduce per data dim whatever
    its number of carries."""
    tensors = list(tensors)
    if not tensors or data_size(mesh) <= 1:
        return tensors
    buf = torch.cat([t.reshape(-1) for t in tensors])
    for a in reversed(data_axes(mesh)):       # 'data' first, then 'pod'
        if _dim_size(mesh, a) > 1:
            dist.all_reduce(buf, op=dist.ReduceOp.SUM,
                            group=mesh.get_group(a))
    sizes = [t.numel() for t in tensors]
    return [part.reshape(t.shape)
            for part, t in zip(torch.split(buf, sizes), tensors)]


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
