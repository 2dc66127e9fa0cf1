"""Wrapper of the hand-written CUDA kernel ``csrc/embedding_bag.cu`` — the
port of the TPU kernel ``_bag_kernel``
(``repro/kernels/embedding_bag/kernel.py:26``).

``embedding_bag_cuda`` checks its operands, allocates the (B, dim) output
and launches one kernel on the current stream; ``launches`` counts its
launches.  The plain PyTorch version is ``ref.embedding_bag_plain``;
``ops.embedding_bag_op`` picks by device.
"""

from __future__ import annotations

import torch

from .. import LaunchCounter, build
from .ref import check_bag

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter()


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
