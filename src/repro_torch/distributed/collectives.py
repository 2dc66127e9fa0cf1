"""The shard context and the cross-shard primitives of the sharded engine
and the sharded ``AnchorIndex`` — the collective layer of the reference's
``repro/core/engine.py`` (``ShardCtx``, ``_psum_items``, ``_merge_topk``,
``_map_item_ids``, ...), over ``torch.distributed`` process groups.

Every per-item buffer the engine and the index touch is this rank's slab,
in LOCAL item coordinates; these helpers are where a global item id meets
a slab.  Three contracts make the sharded search bit-identical to the
single-device one:

1. per-column scores are shard-invariant: each sampling score is an fp32
   contraction over one payload column (plus the blocked noise field, a
   function of global (row, item) coordinates), so a column scores to the
   same bits on any shard;
2. the cross-shard merge selects by (max value, min global id), the rule
   of every index-stable top-k here, so exact ties resolve as on one shard;
3. every contribution has one owner: a column gather or a CE score is
   computed by one shard and summed with exact zeros from the others
   (``x + 0.0`` is exact), or broadcast from its owner.

On a trivial context (``item_group is None``) every helper is the plain
local math: that is the single-device engine.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..kernels import LaunchCounter
from ..kernels.approx_topk.select import stable_topk, topk_value_id


class ShardCtx(NamedTuple):
    """This rank's place on the (data x items) mesh."""

    item_group: Optional[object]   # process group over the item shards (None: one)
    data_group: Optional[object]   # process group over the data shards (None: one)
    n_local: int                   # item columns owned by this rank
    n_item_shards: int
    item_shard: int                # this rank's item-shard index
    row_offset: int                # global row of local batch row 0
    col_map: Optional[torch.Tensor] = None   # (N_local,) global position of each
                                             # local column (None = identity)
    n_data_shards: int = 1


# collectives issued by these helpers, the engine's and ``fsdp``'s (each
# all_reduce, all_gather, all_to_all and broadcast counts one), read by
# chip_smoke per search; ``collective_bytes``: the bytes this rank handed to
# the ones that go through :func:`_count` (these helpers and ``fsdp``'s),
# read by chip_smoke per train step
collective_calls = LaunchCounter()
collective_bytes = LaunchCounter()


def _count(x: torch.Tensor) -> None:
    collective_calls.add()
    collective_bytes.add(x.numel() * x.element_size())


def _local_ctx(n_items: int, col_map=None) -> ShardCtx:
    return ShardCtx(None, None, n_items, 1, 0, 0, col_map, 1)


def _dims_group(mesh, dims):
    """The process group over mesh dimensions ``dims`` (one group per
    combination of the other dimensions; this rank's)."""
    dims = tuple(dims)
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    return mesh[dims]._flatten().get_group()


def _axes_index(group) -> int:
    """This rank's shard index over a group's mesh dimensions: its rank in
    the group, whose ranks run in row-major mesh order (mixed radix, major
    to minor, as ``all_gather`` concatenates)."""
    return dist.get_rank(group)


def _item_offset(ctx: ShardCtx) -> int:
    """Global position of this rank's column 0."""
    return ctx.item_shard * ctx.n_local


def _psum_items(ctx: ShardCtx, x: torch.Tensor) -> torch.Tensor:
    if ctx.item_group is None:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, group=ctx.item_group)
    _count(y)
    return y


def _all_gather(group, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` from every rank of ``group``, concatenated along ``dim`` in
    group-rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    _count(x)
    return torch.cat(parts, dim)


def _merge_topk(ctx: ShardCtx, vals, gidx, k: int):
    """Per-shard (B, k) candidates -> the global (B, k) top-k on every item
    shard: the lists are gathered over the item group and selected by (max
    value, min global id), so exact ties resolve to the lowest global id,
    as one shard ranking all N columns does.  A shard with fewer than k
    live items contributes its lowest masked ids (distinct, at NEG_INF)."""
    if ctx.item_group is None:
        return vals, gidx
    vg = _all_gather(ctx.item_group, vals.to(torch.float32), 1)
    ig = _all_gather(ctx.item_group, gidx.to(torch.int32), 1)
    return topk_value_id(vg, ig, k)


def _local_topk_merge(ctx: ShardCtx, logits, k: int):
    """top-k of a local (B, N_local) score slab -> global ids."""
    v, i = stable_topk(logits, k)
    if ctx.item_group is None:
        return i
    return _merge_topk(ctx, v, i + _item_offset(ctx), k)[1]


def _owned(ctx: ShardCtx, gidx):
    """(local positions clamped into the slab, owned mask) of global ids."""
    local = gidx.long() - _item_offset(ctx)
    owned = (local >= 0) & (local < ctx.n_local)
    return local.clamp(0, ctx.n_local - 1), owned


def _map_item_ids(ctx: ShardCtx, item_ids, gidx):
    """Engine positions -> external corpus ids through the sharded id map."""
    if ctx.item_group is None:
        return item_ids[gidx.long()]
    local, owned = _owned(ctx, gidx)
    return _psum_items(ctx, torch.where(owned, item_ids[local], 0))


def _gather_rows(ctx: ShardCtx, x):
    """This data shard's result rows -> the global batch's, on every rank."""
    if ctx.data_group is None:
        return x
    return _all_gather(ctx.data_group, x, 0)


# dtypes a gloo collective may not take: moved as integers of their width
_WIRE = {torch.bfloat16: torch.int16}
if hasattr(torch, "float8_e4m3fn"):
    _WIRE[torch.float8_e4m3fn] = torch.uint8


def _redistribute(group, x: torch.Tensor, axis: int, src: torch.Tensor, fill) -> torch.Tensor:
    """This rank's new slab of a tensor split along ``axis`` over the item
    shards of ``group`` (every rank's old slab ``x`` has the same width W):
    new position j takes old global position ``src[j]`` (-1: ``fill``).
    The old slabs are broadcast one at a time, so a rank holds at most its
    old slab, its new one and one more."""
    if x.dtype in _WIRE:
        return _redistribute(group, x.view(_WIRE[x.dtype]), axis, src, 0).view(x.dtype)
    width = x.shape[axis]
    shape = list(x.shape)
    shape[axis] = src.shape[0]
    out = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    src = src.to(device=x.device, dtype=torch.int64)
    me = dist.get_rank(group)
    for s in range(dist.get_world_size(group)):
        buf = x.contiguous() if s == me else torch.empty_like(x)
        dist.broadcast(buf, src=dist.get_global_rank(group, s), group=group)
        dst = ((src >= s * width) & (src < (s + 1) * width)).nonzero().squeeze(1)
        if dst.numel():
            out.index_copy_(axis, dst, buf.index_select(axis, src[dst] - s * width))
    return out
