"""Public embedding-bag op — port of ``repro/kernels/embedding_bag``'s
``embedding_bag_op`` (``ops.py:13``): table (rows, dim) fp32/bf16, ids
(B, H) int32 -> (B, dim) in the table's dtype.

On a CUDA tensor it launches the hand-written kernel
(``csrc/embedding_bag.cu`` through ``kernel.embedding_bag_cuda``), or
raises; on a CPU tensor it runs ``ref.embedding_bag_plain``.  There is no
fallback: a kernel that fails to build or launch raises.

Differentiable in the table: where grad mode is on and the table requires
grad, the op is a ``torch.autograd.Function`` whose backward writes the
dense (rows, dim) fp32 gradient the reference's ``jnp.take`` gives — the
backward kernel (``kernel.embedding_bag_backward_cuda``) on the card, its
plain version (``index_add_`` in lookup order) on the CPU.  The ids get no
gradient.

``gather_rows`` (a bag of one id a row) and ``segment_sum`` (the
backward's sum by row, differentiable, whose own backward is the gather)
are NequIP's gather and scatter (``models/gnn/nequip.py``): both
deterministic on the card, since neither kernel adds with atomics.
"""

from __future__ import annotations

import torch

from .kernel import embedding_bag_backward_cuda, embedding_bag_cuda
from .ref import embedding_bag_backward_plain, embedding_bag_plain


def _forward(table, ids, mode):
    if table.is_cuda:
        return embedding_bag_cuda(table, ids, mode)
    return embedding_bag_plain(table, ids, mode)


def embedding_bag_backward(grad_out: torch.Tensor, ids: torch.Tensor, rows: int,
                           mode: str = "sum") -> torch.Tensor:
    """d table (rows, dim) fp32 from the bag output's gradient; the backend
    follows ``grad_out``'s device."""
    if grad_out.is_cuda:
        return embedding_bag_backward_cuda(grad_out, ids, rows, mode)
    return embedding_bag_backward_plain(grad_out, ids, rows, mode)


class _Bag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, mode):
        ctx.save_for_backward(ids)
        ctx.rows, ctx.mode = table.shape[0], mode
        return _forward(table, ids, mode)

    @staticmethod
    def backward(ctx, grad_out):
        (ids,) = ctx.saved_tensors
        return embedding_bag_backward(grad_out, ids, ctx.rows, ctx.mode), None, None


def embedding_bag_op(table: torch.Tensor, ids: torch.Tensor,
                     mode: str = "sum") -> torch.Tensor:
    """Fixed-width multi-hot bag lookup; the backend follows the table's
    device (both check their operands)."""
    if table.requires_grad and torch.is_grad_enabled():
        return _Bag.apply(table, ids, mode)
    return _forward(table, ids, mode)


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (M, dim) for int32 ``ids`` (M,): the bag kernel with one
    id a bag, so its gradient is the backward kernel's deterministic sum."""
    return embedding_bag_op(table, ids[:, None], "sum")


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, ids, n):
        ctx.save_for_backward(ids)
        return embedding_bag_backward(data, ids[:, None], n)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return _forward(grad.contiguous(), ids[:, None], "sum"), None, None


def segment_sum(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """(n, dim) fp32 sums of ``data`` (M, dim)'s rows by int32 segment
    ``ids`` (M,) — ``jax.ops.segment_sum`` with an id outside [-n, n)
    dropped — through the bag's backward (no atomics on the card);
    differentiable in ``data``, its gradient the bag gather."""
    if data.requires_grad and torch.is_grad_enabled():
        return _SegmentSum.apply(data, ids, n)
    return embedding_bag_backward(data, ids[:, None], n)
