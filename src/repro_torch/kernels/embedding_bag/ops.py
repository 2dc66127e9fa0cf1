"""Public embedding-bag op — port of ``repro/kernels/embedding_bag``'s
``embedding_bag_op`` (``ops.py:13``): table (rows, dim) fp32/bf16, ids
(B, H) int32 -> (B, dim) in the table's dtype.

On a CUDA tensor it launches the hand-written kernel
(``csrc/embedding_bag.cu`` through ``kernel.embedding_bag_cuda``), or
raises; on a CPU tensor it runs ``ref.embedding_bag_plain``.  There is no
fallback: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import torch

from .kernel import embedding_bag_cuda
from .ref import embedding_bag_plain


def embedding_bag_op(table: torch.Tensor, ids: torch.Tensor,
                     mode: str = "sum") -> torch.Tensor:
    """Fixed-width multi-hot bag lookup; the backend follows the table's
    device (both check their operands)."""
    if table.is_cuda:
        return embedding_bag_cuda(table, ids, mode)
    return embedding_bag_plain(table, ids, mode)
