"""EmbeddingBag and per-field embedding tables — port of
``repro/models/recsys/embedding.py``.

Every fixed-width bag lookup here (``lookup_all_tables``' per-field
lookups and ``multihot_bag``'s sum and mean) goes through
``kernels.embedding_bag.ops.embedding_bag_op``: the hand-written CUDA
kernel for CUDA tensors, its plain version for CPU tensors.  The segment
form ``embedding_bag`` (bags of any size) has no kernel in the reference
either and stays plain PyTorch (``index_add_``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ...kernels.embedding_bag.ops import embedding_bag_op


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  segment_ids: torch.Tensor, n_bags: int, mode: str = "sum",
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather-and-reduce: out[b] = reduce_{j: seg[j]==b} table[idx[j]];
    empty bags give 0 for sum and mean, -inf for max (``segment_max``)."""
    emb = table[indices.long()]
    if weights is not None:
        emb = emb * weights[:, None]
    seg = segment_ids.long()
    out = torch.zeros((n_bags, table.shape[1]), dtype=emb.dtype, device=emb.device)
    if mode == "sum":
        return out.index_add_(0, seg, emb)
    if mode == "mean":
        s = out.index_add_(0, seg, emb)
        c = torch.zeros((n_bags,), dtype=emb.dtype, device=emb.device)
        c.index_add_(0, seg, torch.ones_like(seg, dtype=emb.dtype))
        return s / torch.clamp(c, min=1.0)[:, None]
    if mode == "max":
        out.fill_(-torch.inf)
        return out.scatter_reduce_(0, seg[:, None].expand_as(emb), emb, "amax")
    raise ValueError(f"unknown mode {mode}")


def multihot_bag(table: torch.Tensor, hot_ids: torch.Tensor,
                 mode: str = "sum") -> torch.Tensor:
    """Fixed-width multi-hot bag: (B, H) ids -> (B, dim).  ``sum`` and
    ``mean`` go through the bag kernel (fp32 accumulation, one cast to the
    table's dtype); ``max`` is plain, as in the reference."""
    if mode in ("sum", "mean"):
        return embedding_bag_op(table, hot_ids, mode)
    if mode == "max":
        return table[hot_ids.long()].amax(dim=1)
    raise ValueError(f"unknown mode {mode}")


PAD_ROWS = 512


def padded_rows(rows: int) -> int:
    """``rows`` rounded up to a multiple of ``PAD_ROWS``: the reference pads
    tables (and the retrieval step's candidate axis) to a shardable
    multiple."""
    return (rows + PAD_ROWS - 1) // PAD_ROWS * PAD_ROWS


def init_tables(generator: torch.Generator, table_sizes: Sequence[int],
                dim: int) -> List[torch.Tensor]:
    """One fp32 table per sparse field, rows padded by ``padded_rows`` (ids
    are taken modulo the padded size, so the pad rows widen the hash
    space), normal draws times ``1/sqrt(dim)`` from ``generator`` on its
    own device.  The scale is applied in place: a 2^24-row table at dim 128
    is 8.6 GB."""
    scale = 1.0 / dim ** 0.5
    return [torch.randn((padded_rows(rows), dim), generator=generator,
                        device=generator.device).mul_(scale)
            for rows in table_sizes]


def lookup_all_tables(tables: Sequence[torch.Tensor], sparse_ids: torch.Tensor) -> torch.Tensor:
    """DLRM-style per-field single-hot lookup: ids (B, F) -> (B, F, dim).

    Each field is one bag of width one through the bag kernel (F launches);
    ids are taken modulo the table's rows (``%`` is floor-mod, as ``jnp``'s
    is)."""
    outs = [
        embedding_bag_op(t, (sparse_ids[:, f] % t.shape[0])[:, None], "sum")
        for f, t in enumerate(tables)
    ]
    return torch.stack(outs, dim=1)
