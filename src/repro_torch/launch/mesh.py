"""Device meshes (port of ``repro.launch.mesh``, and of the reference
trainer's ``parse_mesh``).

Pure functions: importing this module touches no device and no process
group; a mesh is built only when called, over the ranks of an initialized
``torch.distributed`` process group (``init_device_mesh``).

The production shapes stay the reference's: (16, 16) over ("data",
"model") and (2, 16, 16) over ("pod", "data", "model").  Axis order is
outermost first = slowest interconnect first.  On H100 machines of 8 GPUs
a 16-wide ``model`` axis spans two NVLink domains, so its collectives
cross the inter-node network; the reference's torus kept ``model`` on
adjacent links.
"""
from __future__ import annotations

import math
import os
from typing import Sequence, Tuple


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group (whose world size must be the product of ``shape``)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def describe(mesh) -> str:
    """``data=2 x model=4`` for a ``DeviceMesh`` or a {name: size} dict."""
    from repro_torch.distributed.sharding import mesh_shape
    return " x ".join(f"{k}={v}" for k, v in mesh_shape(mesh).items())


def mesh_dims(spec: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """'2x4' -> ((2, 4), ('data', 'model')); one dim is ('data',), three
    add 'pod' in front."""
    dims = tuple(int(x) for x in spec.split("x"))
    axes = {1: ("data",), 2: ("data", "model"),
            3: ("pod", "data", "model")}[len(dims)]
    return dims, axes


def parse_mesh(spec: str, device_type: str = "cuda"):
    """The mesh of a ``--mesh`` value such as '1x2' (the reference
    trainer's ``parse_mesh``)."""
    return make_mesh(*mesh_dims(spec), device_type=device_type)


def setup_mesh(spec: str, device):
    """(mesh, this rank's device) for a launcher's ``--mesh``; (None,
    device) for a mesh of one device.  Initializes the process group from
    ``torchrun``'s environment where none is: NCCL when every rank has a
    card of its own, else gloo (ranks sharing one card, or the CPU)."""
    import torch
    import torch.distributed as dist
    dims, _ = mesh_dims(spec)
    if math.prod(dims) == 1:
        return None, device
    if not dist.is_initialized():
        if "RANK" not in os.environ:
            raise RuntimeError(
                f"--mesh {spec} takes {math.prod(dims)} ranks: run under "
                f"torchrun --nproc-per-node {math.prod(dims)}, or in a "
                f"process whose torch.distributed group is initialized")
        cuda = device.type == "cuda"
        local = int(os.environ.get("LOCAL_RANK", 0))
        nccl = cuda and torch.cuda.device_count() >= int(
            os.environ.get("LOCAL_WORLD_SIZE", os.environ.get(
                "WORLD_SIZE", 1)))
        dist.init_process_group("nccl" if nccl else "gloo")
        if cuda:
            device = torch.device("cuda", local if nccl else 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return parse_mesh(spec, device.type), device
