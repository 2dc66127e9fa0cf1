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

from typing import Callable, List, Optional, Sequence

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
                dim: int, place: Optional[Callable] = None) -> List[torch.Tensor]:
    """One fp32 table per sparse field, rows padded by ``padded_rows`` (ids
    are taken modulo the padded size, so the pad rows widen the hash
    space), normal draws times ``1/sqrt(dim)`` from ``generator`` on its
    own device.  The scale is applied in place: a 2^24-row table at dim 128
    is 8.6 GB.  ``place(path, table)``, where given, takes each table as it
    is drawn and returns what is kept (a rank's piece over a mesh), so at
    most one whole table lives at a time."""
    scale = 1.0 / dim ** 0.5
    place = place or (lambda path, t: t)
    return [place(f"tables/{i}", torch.randn((padded_rows(rows), dim), generator=generator,
                                             device=generator.device).mul_(scale))
            for i, rows in enumerate(table_sizes)]


def table_specs(n_tables: int) -> List[tuple]:
    """The logical axes of :func:`init_tables`' tables (row-sharded)."""
    return [("table_rows", "embed") for _ in range(n_tables)]


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


def owned_rows_bag(piece: torch.Tensor, ids: torch.Tensor, lo: int, rows: int) -> torch.Tensor:
    """(M, dim): row ``ids[i] % rows`` of a table whose rows [lo, lo +
    len(piece)) are ``piece``, or 0 where another rank owns it; through the
    bag kernel, differentiable in ``piece`` (its gradient the bag's backward
    over the local rows only: a foreign id is passed as a dropped one)."""
    local = ids.long() % rows - lo
    owned = (local >= 0) & (local < piece.shape[0])
    local_ids = torch.where(owned, local, piece.shape[0]).to(torch.int32)[:, None]
    return torch.where(owned[:, None], embedding_bag_op(piece, local_ids, "sum"), 0.0)


def lookup_row_sharded(tables: Sequence[torch.Tensor], shardings, sparse_ids: torch.Tensor,
                       mesh) -> torch.Tensor:
    """:func:`lookup_all_tables` over row-sharded tables: this rank's
    pieces of the tables (``shardings``: each one's ``Sharding``, its rows
    over some mesh dimensions T) and this rank's batch shard of the ids
    (B_l, F) -> this rank's (B_l, F, dim), differentiable in the pieces.

    The ranks that share a table's rows gather their batch shards' ids
    (over T's batch dimensions), bag the ids they own through the bag
    kernel (an id another rank owns is masked: read as a dropped id and
    replaced by 0, so its gradient, the bag's backward kernel over the
    local rows only, drops it too), then reduce-scatter the partial bags
    over T so each rank gets the sums for its batch rows (and all-gathers
    them over T's other dimensions, whose ranks share a batch shard).
    The ids are taken modulo the table's whole row count, as one device
    takes them."""
    from ...distributed import fsdp
    from ...distributed.sharding import batch_axes

    bx = set(batch_axes(mesh))
    groups: dict = {}
    for f, sh in enumerate(shardings):
        if any(sh.dim_axes(d) for d in range(1, len(sh.spec))):
            raise ValueError(f"table {f} is sharded along its embedding dimension "
                             f"({sh.spec}); only its rows may be")
        groups.setdefault(sh.dim_axes(0), []).append(f)
    out = [None] * len(tables)
    for rows_axes, fields in groups.items():
        tb = tuple(a for a in rows_axes if a in bx)
        tm = tuple(a for a in rows_axes if a not in bx)
        if rows_axes[:len(tb)] != tb:
            raise ValueError(f"table rows over {rows_axes}: the batch dimensions must lead")
        ids = fsdp.all_gather(sparse_ids[:, fields], fsdp.mesh_group(mesh, tb), 0)
        partial = torch.stack([
            owned_rows_bag(tables[f], ids[:, j], shardings[f].index(0) * tables[f].shape[0],
                           tables[f].shape[0] * shardings[f].parts(0))
            for j, f in enumerate(fields)], dim=1)
        mine = fsdp.reduce_scatter(partial, fsdp.mesh_group(mesh, rows_axes), 0)
        emb = fsdp.all_gather(mine, fsdp.mesh_group(mesh, tm), 0)
        for j, f in enumerate(fields):
            out[f] = emb[:, j]
    return torch.stack(out, dim=1)
