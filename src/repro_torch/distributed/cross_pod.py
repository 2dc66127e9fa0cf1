"""The compressed cross-pod gradient reduction — port of
``repro/distributed/cross_pod.py::make_hierarchical_grad_reduce``.

On a mesh with a ``pod`` dimension the pod link is an order slower than
the links inside a pod, so the reduction is split:

1. inside each pod, a full-precision mean over the pod's data-parallel
   ranks (the ``data`` dimension), for every leaf that is not split over
   ``data``;
2. across pods, int8 codes with one scale shared by the pods (a MAX of one
   scalar over ``pod``) and error feedback; the codes are summed as int32,
   so the sum is exact, and the mean is that sum times the scale over the
   pod count.

Each rank holds its own piece of every leaf (one process per rank), so the
reference's ``strip_pod`` of a leaf's placement becomes the caller's word
on which mesh dimensions split it (``split``); the scale is the max over
this rank's piece, as the reference's is over its shard.  Without a
``pod`` dimension the reduce is the identity, as the reference's is.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..tree import leaves_with_paths, unflatten_like
from .collectives import _dims_group
from .compression import int8_codes
from .sharding import batch_axes, check_mesh_device, mesh_dims


def int8_pod_payload(g32: torch.Tensor, pod_group) -> tuple:
    """(int8 codes, shared fp32 scale) of ``g32``: the scale is the max
    |g32| over the pods / 127 + 1e-12, the codes ``g32`` over it, rounded
    half to even and clipped to ±127 (the reference's ``one``)."""
    amax = g32.abs().max().reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=pod_group)
    scale = amax[0] / 127.0 + 1e-12
    return int8_codes(g32, scale), scale


def make_hierarchical_grad_reduce(mesh, split: Optional[Dict[str, Sequence[str]]] = None,
                                  device=None):
    """``reduce(grads, err) -> (reduced grads, new err)`` on ``mesh`` (a
    ``DeviceMesh``; every rank calls it with its own pieces).

    ``split`` maps a leaf's path (``repro_torch.tree``'s, ``layers/0/w``)
    to the mesh dimensions that split it; a leaf it does not name is whole
    on every rank.  ``err`` is a tree of fp32 residuals shaped like
    ``grads`` (``compression.init_error_feedback``).  The reduced leaves
    come back in their own dtype; the pod link carries one int8 per
    element, plus one fp32 scale a leaf; ``reduce.last_payload`` holds the
    last call's {path: (int8 codes, scale)}, what this rank sent.
    ``device`` is the card unless the caller passes ``"cpu"`` (the device
    rule); it must be the mesh's."""
    check_mesh_device(mesh, device)
    dims = mesh_dims(mesh)
    if "pod" not in dims:
        return lambda grads, err: (grads, err)
    split = {k: tuple(v) for k, v in (split or {}).items()}
    n_pods = dims["pod"]
    pod_group = _dims_group(mesh, ("pod",))
    data_dims = tuple(a for a in batch_axes(mesh) if a != "pod")

    def reduce_fn(grads, err):
        errs = dict(leaves_with_paths(err))
        outs, new_errs, payload = [], [], {}
        for path, g in leaves_with_paths(grads):
            g32 = g.to(torch.float32)
            dp = tuple(a for a in data_dims if a not in split.get(path, ()) and dims[a] > 1)
            if dp:   # the pod's data-parallel mean, in full precision
                g32 = g32.clone()
                dist.all_reduce(g32, group=_dims_group(mesh, dp))
                g32 /= math.prod(dims[a] for a in dp)
            g32 = g32 + errs[path]
            q, scale = int8_pod_payload(g32, pod_group)
            q_sum = q.to(torch.int32)
            dist.all_reduce(q_sum, group=pod_group)          # the int8 payload, summed exactly
            outs.append((q_sum.to(torch.float32) * scale / n_pods).to(g.dtype))
            new_errs.append(g32 - q.to(torch.float32) * scale)
            payload[path] = (q, scale)
        reduce_fn.last_payload = payload
        return unflatten_like(grads, outs), unflatten_like(grads, new_errs)

    return reduce_fn


def pod_link_bytes(grads) -> Dict[str, int]:
    """Bytes one rank sends over the pod link a step: int8 codes plus a
    scale a leaf, against the fp32 payload the plain reduce would send."""
    leaves = [g for _, g in leaves_with_paths(grads)]
    return {"int8": sum(g.numel() + 4 for g in leaves), "fp32": sum(4 * g.numel() for g in leaves)}
