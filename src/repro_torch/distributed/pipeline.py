"""Pipeline parallelism over a mesh dimension, GPipe's schedule — port of
``repro/distributed/pipeline.py`` (``pipeline_forward``, ``split_stages``).

S stages over one mesh dimension, stage s on its rank s; M microbatches
stream through in S + M - 1 ticks, each rank running its stage on the
microbatch it holds and shifting the activation to the next rank; the
last stage's outputs are summed to every rank (the others contribute
zeros, so the sum is exact).  The bubble share is (S - 1) / (S + M - 1).

The reference shifts with ``ppermute``.  The port shifts with an
``all_to_all_single`` whose splits send the whole activation to the next
rank and nothing elsewhere: gloo's ``send`` / ``recv`` write a CUDA
tensor's device pointer to the socket and fail ("Bad address"), while its
all-to-all stages CUDA tensors through host memory.  A rank outside its
window (before its first microbatch arrives, after its last leaves) runs
no stage: the reference computes those ticks on stale buffers and never
reads them, so the output is the same.

The port's layers are a per-layer list, not stacked, so ``split_stages``
gives stage s its contiguous span of the list.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

from .collectives import _dims_group
from .sharding import check_mesh_device


def _shift(y, like: torch.Tensor, send: bool, recv: bool, group, rank: int, n: int):
    """Rank r's ``y`` (when ``send``) to rank r + 1; returns what rank
    r - 1 sent (when ``recv``, else None).  Every rank of ``group`` calls
    it; a send and its receive agree on the schedule, so each split size
    matches its peer's."""
    numel = like.numel()
    sizes_in = [numel if send and j == rank + 1 else 0 for j in range(n)]
    sizes_out = [numel if recv and j == rank - 1 else 0 for j in range(n)]
    flat = y.contiguous().reshape(-1) if send else like.new_empty(0)
    out = like.new_empty(numel if recv else 0)
    dist.all_to_all_single(out, flat, sizes_out, sizes_in, group=group)
    return out.reshape(like.shape) if recv else None


def pipeline_forward(mesh, stage_fn: Callable, pipe_axis: str, n_microbatches: int,
                     device=None):
    """``piped(stage_params, x) -> out`` over ``mesh`` (every rank calls
    it): ``stage_params`` this rank's stage (rank s of ``pipe_axis``), x
    the whole (M * mb, ...) batch on every rank, split into M microbatches;
    out the last stage's (M * mb, ...) result on every rank.  ``device`` is
    the card unless the caller passes ``"cpu"`` (the device rule)."""
    check_mesh_device(mesh, device)
    group = _dims_group(mesh, (pipe_axis,))
    n_stages, rank = dist.get_world_size(group), dist.get_rank(group)
    m = n_microbatches

    def piped(stage_params, x):
        if x.shape[0] % m:
            raise ValueError(f"batch {x.shape[0]} does not split into {m} microbatches")
        micro = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
        out = torch.zeros_like(micro)
        buf = None

        def active(r, t):                          # rank r holds microbatch t - r
            return r <= t < r + m

        for t in range(m + n_stages - 1):
            y = None
            if active(rank, t):
                y = stage_fn(stage_params, micro[t] if rank == 0 else buf)
                if rank == n_stages - 1:
                    out[t - rank] = y
            if n_stages > 1:
                buf = _shift(y, micro[0], rank < n_stages - 1 and active(rank, t),
                             rank > 0 and active(rank - 1, t), group, rank, n_stages)
        dist.all_reduce(out, group=group)          # ranks but the last wrote zeros
        return out.reshape(x.shape)

    return piped


def split_stages(layer_list: Sequence, n_stages: int) -> List[list]:
    """A per-layer list -> ``n_stages`` contiguous spans, stage-major (the
    reference's (L, ...) -> (S, L / S, ...) reshape)."""
    n = len(layer_list)
    if n % n_stages:
        raise ValueError(f"{n} layers do not split into {n_stages} stages")
    per = n // n_stages
    return [list(layer_list[s * per:(s + 1) * per]) for s in range(n_stages)]
