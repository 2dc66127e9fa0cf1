"""Wrapper of the hand-written CUDA kernel ``csrc/embedding_bag.cu`` — the
port of the TPU kernel ``_bag_kernel``
(``repro/kernels/embedding_bag/kernel.py:26``).

``embedding_bag_cuda`` checks its operands, allocates the (B, dim) output
and launches one kernel on the current stream; ``launches`` counts its
launches.  ``embedding_bag_backward_cuda`` (the gradient the training step
needs; the TPU kernel has none) checks its operands, allocates the dense
gradient and one scratch buffer with ``torch.empty`` and launches the
backward's kernels, which sort the lookups by row and write every row
themselves; ``backward_launches`` counts its calls.  The plain PyTorch
versions are ``ref.embedding_bag_plain`` and
``ref.embedding_bag_backward_plain``; ``ref.embedding_bag_backward_emulated``
repeats the backward kernel's order of additions.  ``ops`` picks by device.
"""

from __future__ import annotations

import contextlib

import torch

from .. import LaunchCounter, build
from .ref import MODES, check_bag

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter()
backward_launches = LaunchCounter()


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


def _current_stream(index: int) -> int:
    """The device's current CUDA stream as a pointer (``torch.cuda.current_stream``
    builds a Stream object, a large part of a small call's host time)."""
    return torch._C._cuda_getCurrentRawStream(index)


def embedding_bag_backward_cuda(grad_out: torch.Tensor, ids: torch.Tensor, rows: int,
                                mode: str = "sum") -> torch.Tensor:
    """d table (rows, dim) fp32 of a bag whose output's gradient is
    ``grad_out`` (B, dim) fp32 or bf16, on the card; deterministic (no
    atomics).  Both operands may be strided."""
    if not grad_out.is_cuda or ids.device != grad_out.device:
        raise ValueError("the CUDA kernel needs CUDA tensors on one device (the plain "
                         "version serves CPU tensors)")
    if mode not in MODES:
        raise ValueError(f"embedding-bag mode must be one of {MODES}, got {mode!r}")
    if ids.dim() != 2 or ids.dtype != torch.int32 or grad_out.dim() != 2 \
            or grad_out.shape[0] != ids.shape[0]:
        raise ValueError(f"grad_out (B, dim) and int32 ids (B, H), got "
                         f"{tuple(grad_out.shape)} and {tuple(ids.shape)} {ids.dtype}")
    if grad_out.dtype not in DTYPES:
        raise ValueError(f"the kernel takes a float32 or bfloat16 grad_out, got "
                         f"{grad_out.dtype}")
    (b, h), dim = ids.shape, grad_out.shape[1]
    if not 1 <= rows < 2 ** 31 - 1 or b * h >= 2 ** 31:
        raise ValueError(f"the kernel takes rows in [1, 2^31 - 1) and B * H < 2^31, got "
                         f"rows {rows}, B * H {b * h}")
    lib = build.load("embedding_bag")
    dev = grad_out.device
    dt = torch.empty((rows, dim), dtype=torch.float32, device=dev)
    scratch = torch.empty(lib.embedding_bag_backward_scratch(b * h, rows, dim),
                          dtype=torch.uint8, device=dev)
    sgb, sgd = grad_out.stride()
    vec = dim % 4 == 0 and sgd == 1 and sgb % 4 == 0 \
        and grad_out.data_ptr() % (4 * grad_out.element_size()) == 0
    # the launcher forks a stream of the current device for a large table
    with (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
          else contextlib.nullcontext()):
        err = lib.embedding_bag_backward_launch(
            build.ptr(grad_out), DTYPES[grad_out.dtype], sgb, sgd, build.ptr(ids),
            *ids.stride(), build.ptr(dt), build.ptr(scratch), b, h, rows, dim,
            int(mode == "mean"), int(vec), _current_stream(dev.index))
    build.check(err, "embedding_bag_backward")
    backward_launches.add()
    return dt
