"""Serving meshes over ``torch.distributed`` — port of
``repro/launch/mesh.py``'s ``make_mesh`` and ``make_serving_mesh``.

The reference is one process over many devices; the port runs one process
per rank (``torchrun --nproc-per-node D*I``), and a mesh is a
``DeviceMesh`` over the world group.  The backend follows the device:
NCCL on ``cuda``, gloo on ``cpu``; ``backend=`` overrides it.  Several
ranks on one card need the override: NCCL refuses two ranks on one device,
so they run gloo over CUDA tensors (gloo stages each collective through
host memory).  The pod mesh (``make_production_mesh``) belongs to
training and is not ported.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from ..device import resolve_device


def _init_world(device: torch.device, backend) -> None:
    """The default process group, from the launcher's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), unless the
    caller already made one."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend=backend)


def make_mesh(shape, axes, device=None, backend=None):
    """A ``DeviceMesh`` of ``shape`` with dimension names ``axes`` over the
    world (the card unless ``device="cpu"``).  On the card each rank's
    current device is ``LOCAL_RANK`` modulo the cards there are, set before
    the mesh exists, so several ranks may share one card.  A mesh whose size
    differs from the world size raises."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    _init_world(dev, backend)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} needs {math.prod(shape)} ranks, "
                         f"but the world has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_serving_mesh(data: int, items: int, device=None, backend=None):
    """The retrieval-serving mesh: ``data`` shards the query batch,
    ``items`` shards the AnchorIndex payload and the engine's per-shard item
    slabs (``core.engine.make_sharded_engine``).  ``data * items`` must
    equal the world size."""
    return make_mesh((data, items), ("data", "items"), device=device, backend=backend)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors of ``mesh`` live on."""
    dev = resolve_device(mesh.device_type)
    return torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" else dev
