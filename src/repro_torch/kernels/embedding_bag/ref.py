"""Plain PyTorch version of the embedding-bag kernel — the arithmetic of
the TPU kernel ``_bag_kernel`` (``repro/kernels/embedding_bag/kernel.py:26``)
over the gather of its oracle ``embedding_bag_reference`` (``ref.py:9``).

``out[b] = Σ_h table[ids[b, h]]`` (or that sum / H for ``mean``) with an
fp32 accumulator over h = 0..H-1 in ascending order, one divide by H in
fp32 for ``mean``, then one cast to the table's dtype, as the Pallas kernel
does.  The CUDA kernel (``csrc/embedding_bag.cu``) adds in the same order,
so the two agree bit for bit.  Ids follow ``jnp.take``: an id in
[-rows, 0) wraps once, one outside [-rows, rows) reads as a row of NaN.
"""

from __future__ import annotations

import torch

MODES = ("sum", "mean")


def check_bag(table: torch.Tensor, ids: torch.Tensor, mode: str) -> None:
    """Raise on what neither version takes."""
    if mode not in MODES:
        raise ValueError(f"embedding-bag mode must be one of {MODES}, got {mode!r}")
    if table.dim() != 2:
        raise ValueError(f"table must be (rows, dim), got {tuple(table.shape)}")
    if ids.dim() != 2:
        raise ValueError(f"ids must be (B, H), got {tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32 integers (the reference kernel's id "
                         f"type), got {ids.dtype}")
    if ids.shape[1] == 0:
        raise ValueError("a bag needs H >= 1 ids (got H = 0)")
    if ids.device != table.device:
        raise ValueError(f"ids on {ids.device} but the table on {table.device}")


def embedding_bag_plain(table: torch.Tensor, ids: torch.Tensor,
                        mode: str = "sum") -> torch.Tensor:
    """(B, dim) bag in the table's dtype; any device."""
    check_bag(table, ids, mode)
    rows, h = table.shape[0], ids.shape[1]
    idx = ids.long()
    idx = torch.where(idx < 0, idx + rows, idx)
    bad = (idx < 0) | (idx >= rows)
    gathered = table[idx.clamp(0, rows - 1)]                 # (B, H, dim)
    acc = gathered[:, 0].to(torch.float32, copy=True).masked_fill_(bad[:, 0, None], torch.nan)
    for i in range(1, h):
        acc += gathered[:, i].float().masked_fill(bad[:, i, None], torch.nan)
    if mode == "mean":
        # a divide by a tensor on acc's device: on the card, a divide by a
        # Python number becomes a multiply by its reciprocal
        acc /= torch.tensor(float(h), dtype=torch.float32, device=acc.device)
    return acc.to(table.dtype)


def row_keys(ids: torch.Tensor, rows: int) -> torch.Tensor:
    """The (B * H,) int64 table row of each lookup in lookup order (b, h):
    an id in [-rows, 0) wraps once, one outside [-rows, rows) becomes
    ``rows`` (its gather read NaN; it takes no part in the gradient, as
    jnp.take's scatter-add drops it)."""
    idx = ids.reshape(-1).long()
    idx = torch.where(idx < 0, idx + rows, idx)
    return torch.where((idx < 0) | (idx >= rows), rows, idx)


def embedding_bag_backward_plain(grad_out: torch.Tensor, ids: torch.Tensor, rows: int,
                                 mode: str = "sum") -> torch.Tensor:
    """d table (rows, dim) fp32 of the bag: ``index_add_`` of each lookup's
    ``grad_out[b]`` (``/ H`` for ``mean``, an fp32 divide) in lookup order,
    dropped ids left out; any device."""
    if mode not in MODES:
        raise ValueError(f"embedding-bag mode must be one of {MODES}, got {mode!r}")
    b, h = ids.shape
    g = grad_out.float()
    if mode == "mean":
        g = g / torch.tensor(float(h), dtype=torch.float32, device=g.device)
    keys = row_keys(ids, rows)
    keep = keys < rows
    src = g[:, None, :].expand(b, h, g.shape[1]).reshape(b * h, -1)
    out = torch.zeros((rows, g.shape[1]), dtype=torch.float32, device=g.device)
    return out.index_add_(0, keys[keep], src[keep])
