"""Serving meshes over ``torch.distributed`` — port of
``repro/launch/mesh.py``'s ``make_mesh`` and ``make_serving_mesh``.

The reference is one process over many devices; the port runs one process
per rank (``torchrun --nproc-per-node D*I``), and a mesh is a
``DeviceMesh`` over the world group.  The backend follows the device:
NCCL on ``cuda``, gloo on ``cpu``; ``backend=`` overrides it.  Several
ranks on one card need the override: NCCL refuses two ranks on one device,
so they run gloo over CUDA tensors (gloo stages each collective through
host memory).  ``make_replica_meshes`` splits one world into serving
replicas, each a mesh with groups of its own.  ``make_production_mesh`` is
the training mesh over the reference's axes.

An entry point that makes the default process group ends it on every
path, normal or failed (:func:`end_world`): a process that exits with a
gloo group still live may abort in the group's threads at exit
("terminate called without an active exception").
"""

from __future__ import annotations

import gc
import math
import os
from datetime import timedelta
from typing import Dict, NamedTuple, Optional

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


def end_world(sync: bool = True) -> None:
    """End this process's default process group and every group made from
    it (a no-op without one).  ``sync`` (the normal path) first waits at a
    barrier, so no peer is still inside a collective with this rank; a
    failed path passes ``sync=False`` (a peer may never arrive).  Objects
    no longer referenced that hold groups are collected first, so the
    groups' connections close here, not at the interpreter's exit."""
    if not dist.is_initialized():
        return
    try:
        if sync:
            dist.barrier()
    finally:
        gc.collect()
        dist.destroy_process_group()
        gc.collect()


PRODUCTION_SHAPE = (16, 16)              # chips of one pod: (data, model)
PRODUCTION_MULTI_POD_SHAPE = (2, 16, 16)  # (pod, data, model)


def make_production_mesh(*, multi_pod: bool = False, shape=None, device=None, backend=None):
    """The training mesh over the reference's axes: ``("data", "model")``,
    or ``("pod", "data", "model")`` when ``multi_pod`` ("data" = DP/FSDP,
    "model" = TP/EP, "pod" = cross-pod DP).  Without ``shape`` it is the
    reference's (16, 16) or (2, 16, 16) and needs that many ranks; a given
    ``shape`` must have one size per axis.  Either way a world of another
    size raises (:func:`make_mesh`)."""
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if shape is None:
        shape = PRODUCTION_MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes) or any(s < 1 for s in shape):
        raise ValueError(f"a production mesh of axes {axes} needs {len(axes)} positive sizes, "
                         f"got {shape}")
    return make_mesh(shape, axes, device=device, backend=backend)


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


class ReplicaMesh(NamedTuple):
    """This rank's place in a world of serving replicas."""

    replica: int               # which replica this rank serves in
    mesh: object               # that replica's (data x items) DeviceMesh
    group: str                 # the name of the process group over that replica's
                               # ranks (AdaCURService(group=)): a name, so that
                               # holding this tuple keeps no group alive
    control: str               # the name of the group its followers wait on for
                               # each batch (AdaCURService(control=))
    leader: int                # the global rank of its leader (its first rank)
    links: Dict[int, object]   # replica -> the two-rank group {0, its leader} (replicas 1..)


REPLICA_TIMEOUT_S = 60.0


def make_replica_meshes(replicas: int, data: int, items: int, device=None,
                        backend=None, timeout_s: float = REPLICA_TIMEOUT_S,
                        control_timeout_s: Optional[float] = None) -> ReplicaMesh:
    """A world of ``replicas x data x items`` ranks as ``replicas``
    serving meshes of ``data x items`` each, replica r on the world's ranks
    [r * data * items, (r + 1) * data * items), row-major; ``launch/router.py``
    serves them from rank 0.  Every rank creates every group, in one order
    (``new_group`` is collective over the world), and each replica's mesh is
    built from its own groups (``DeviceMesh.from_group``): a replica whose
    service ends its groups after a failed search
    (``AdaCURService._fail_mesh``) ends no other replica's.  The groups a
    batch's collectives run on (the mesh's dimensions and the replica's
    ``group``) time out after ``timeout_s``, so a peer of a failed rank
    fails then at the latest, even where something still holds the failed
    rank's groups open.  The ``control`` group, where the followers wait
    for the next batch, and the links, which carry the router's traffic to
    the replicas rank 0 does not lead, keep the backend's default timeout
    unless ``control_timeout_s`` is given, so the batch bound does not end
    an idle replica; keep-alive headers every sixth of that timeout hold an
    idle replica's followers (the leader's ``AdaCURService``) and its
    leader (``router.RemoteReplica``) past it.  ``device`` is the card unless the
    caller passes ``"cpu"``; the backend follows it, as in
    :func:`make_mesh`."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    _init_world(dev, backend)
    size = data * items
    if replicas * size != dist.get_world_size():
        raise ValueError(f"{replicas} replicas of {data}x{items} need {replicas * size} ranks, "
                         f"but the world has {dist.get_world_size()}")
    rank = dist.get_rank()
    mine = rank // size
    grid = torch.arange(replicas * size).reshape(replicas, data, items)
    own = {}
    bound = timedelta(seconds=timeout_s)
    control = ({} if control_timeout_s is None
               else {"timeout": timedelta(seconds=control_timeout_s)})
    for r in range(replicas):
        groups = {
            "data": [dist.new_group(grid[r, :, i].tolist(), timeout=bound)
                     for i in range(items)],
            "items": [dist.new_group(grid[r, d, :].tolist(), timeout=bound)
                      for d in range(data)],
            "all": dist.new_group(grid[r].reshape(-1).tolist(), timeout=bound),
            "control": dist.new_group(grid[r].reshape(-1).tolist(), **control),
        }
        if r == mine:
            own = groups
    links = {r: dist.new_group([0, r * size], **control) for r in range(1, replicas)}
    d, i = divmod(rank - mine * size, items)
    mesh = DeviceMesh.from_group([own["data"][i], own["items"][d]], dev.type,
                                 mesh=grid[mine].tolist(), mesh_dim_names=("data", "items"))
    return ReplicaMesh(mine, mesh, own["all"].group_name, own["control"].group_name,
                       mine * size, links)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors of ``mesh`` live on."""
    dev = resolve_device(mesh.device_type)
    return torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" else dev
