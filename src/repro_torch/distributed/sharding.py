"""Logical-axis sharding rules over a ``DeviceMesh`` — the part of
``repro/distributed/sharding.py`` that the AnchorIndex and the sharded
engine read (the LM, recsys and GNN rules come with their models).

A spec here is a tuple with one entry per tensor dimension: ``None``
(replicated), a mesh dimension name, or a tuple of names (that dimension
split over several mesh dimensions, major to minor).  Rules are
divisibility-checked per tensor: a logical dimension that does not divide
by its mesh dimensions falls back to replication, and a mesh dimension is
used at most once per spec (the first logical dimension wins).

The functions read only a mesh's dimension names and sizes, so anything
with ``mesh_dim_names`` and ``shape`` (a ``torch.distributed`` DeviceMesh)
works.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from ..device import resolve_device

Axes = Union[str, Tuple[str, ...], None]

# logical axis -> preferred mesh dimensions, tried in order.  On a serving
# (data x items) mesh the item axis lives on "items" (the data dimension
# shards the query batch); on other meshes it spreads over the whole mesh.
DEFAULT_RULES: Dict[str, Sequence[Axes]] = {
    "items": (
        ("items",),
        ("pod", "data", "model"), ("data", "model"), ("data",), ("model",),
    ),
    "anchor_q": (None,),
}


def mesh_dims(mesh) -> Dict[str, int]:
    """{dimension name: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def axis_size(mesh, axes: Axes) -> int:
    if axes is None:
        return 1
    dims = mesh_dims(mesh)
    size = 1
    for a in ((axes,) if isinstance(axes, str) else axes):
        size *= dims[a]
    return size


def spec_for(mesh, logical: Tuple[str, ...], shape: Tuple[int, ...],
             rules: Optional[Dict[str, Sequence[Axes]]] = None) -> tuple:
    """One logical-axes tuple -> a spec (trailing replicated dims dropped)."""
    rules = rules or DEFAULT_RULES
    dims = mesh_dims(mesh)
    used: set = set()
    out = []
    for name, dim in zip(logical, shape):
        chosen: Axes = None
        for cand in rules.get(name, (None,)):
            if cand is None:
                break
            cand_t = (cand,) if isinstance(cand, str) else tuple(cand)
            if any(a not in dims for a in cand_t) or any(a in used for a in cand_t):
                continue
            if dim % axis_size(mesh, cand_t):
                continue
            chosen = cand if isinstance(cand, str) else cand_t
            used.update(cand_t)
            break
        out.append(chosen)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh dimensions that shard the batch (pod composes with data)."""
    dims = mesh_dims(mesh)
    return tuple(a for a in ("pod", "data") if a in dims)


def check_mesh_device(mesh, device=None) -> torch.device:
    """The device rule for an entry point over a mesh: ``device`` (the card
    unless the caller passes ``"cpu"``), which the mesh must live on."""
    dev = resolve_device(device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot run on device {dev}")
    return dev
