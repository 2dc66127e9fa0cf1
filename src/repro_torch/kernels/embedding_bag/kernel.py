"""Wrapper of the hand-written CUDA kernel ``csrc/embedding_bag.cu`` — the
port of the TPU kernel ``_bag_kernel``
(``repro/kernels/embedding_bag/kernel.py:26``).

``embedding_bag_cuda`` checks its operands, allocates the (B, dim) output
and launches one kernel on the current stream; ``launches`` counts its
launches.  ``embedding_bag_backward_cuda`` sorts the lookups' rows and
launches the backward's two passes (the gradient the training step
needs; the TPU kernel has none); ``backward_launches`` counts its calls.
The plain PyTorch versions are ``ref.embedding_bag_plain`` and
``ref.embedding_bag_backward_plain``; ``ops`` picks by device.
"""

from __future__ import annotations

import torch

from .. import LaunchCounter, build
from .ref import MODES, check_bag, row_keys

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter()
backward_launches = LaunchCounter()
BACKWARD_TILE = 32        # sorted lookups a warp sums in the backward's first pass


def embedding_bag_cuda(table: torch.Tensor, ids: torch.Tensor,
                       mode: str = "sum") -> torch.Tensor:
    """(B, dim) bag in the table's dtype, on the card."""
    check_bag(table, ids, mode)
    if not table.is_cuda:
        raise ValueError("the CUDA kernel needs CUDA tensors (the plain version "
                         "serves CPU tensors)")
    if table.dtype not in DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16 tables, got {table.dtype}")
    if not table.is_contiguous():
        raise ValueError("the table must be contiguous (rows, dim)")
    ids = ids.contiguous()
    (rows, dim), (b, h) = table.shape, ids.shape
    out = torch.empty((b, dim), dtype=table.dtype, device=table.device)
    vec16 = (dim * table.element_size() % 16 == 0 and table.data_ptr() % 16 == 0
             and out.data_ptr() % 16 == 0)
    lib = build.load("embedding_bag")
    err = lib.embedding_bag_launch(
        build.ptr(table), build.ptr(ids), build.ptr(out), DTYPES[table.dtype], b, h,
        rows, dim, int(mode == "mean"), int(vec16),
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    build.check(err, "embedding_bag")
    launches.add()
    return out


def embedding_bag_backward_cuda(grad_out: torch.Tensor, ids: torch.Tensor, rows: int,
                                mode: str = "sum") -> torch.Tensor:
    """d table (rows, dim) fp32 of a bag whose output's gradient is
    ``grad_out`` (B, dim), on the card; deterministic (no atomics)."""
    if not grad_out.is_cuda or ids.device != grad_out.device:
        raise ValueError("the CUDA kernel needs CUDA tensors on one device (the plain "
                         "version serves CPU tensors)")
    if mode not in MODES:
        raise ValueError(f"embedding-bag mode must be one of {MODES}, got {mode!r}")
    if ids.dim() != 2 or ids.dtype != torch.int32 or grad_out.dim() != 2 \
            or grad_out.shape[0] != ids.shape[0]:
        raise ValueError(f"grad_out (B, dim) and int32 ids (B, H), got "
                         f"{tuple(grad_out.shape)} and {tuple(ids.shape)} {ids.dtype}")
    g = grad_out.float().contiguous()
    (b, h), dim = ids.shape, g.shape[1]
    keys, perm = torch.sort(row_keys(ids, rows), stable=True)
    n = b * h
    tiles = -(-n // BACKWARD_TILE)
    dt = torch.zeros((rows, dim), dtype=torch.float32, device=g.device)
    head = torch.empty((tiles, dim), dtype=torch.float32, device=g.device)
    tail = torch.empty_like(head)
    vec16 = dim % 4 == 0 and g.data_ptr() % 16 == 0 and dt.data_ptr() % 16 == 0 \
        and head.data_ptr() % 16 == 0 and tail.data_ptr() % 16 == 0
    lib = build.load("embedding_bag")
    err = lib.embedding_bag_backward_launch(
        build.ptr(keys), build.ptr(perm), build.ptr(g), build.ptr(dt), build.ptr(head),
        build.ptr(tail), n, BACKWARD_TILE, h, rows, dim, int(mode == "mean"), int(vec16),
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    build.check(err, "embedding_bag_backward")
    backward_launches.add()
    return dt
