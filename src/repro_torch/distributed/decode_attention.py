"""Sequence-parallel decode attention: the KV cache split along its
SEQUENCE — port of ``repro/distributed/decode_attention.py``.

A long cache cannot be split by heads when there are fewer KV heads than
ranks, so its sequence axis is split over ``seq_axes`` (over every
dimension for the batch-1 ``long_500k`` cell) and its batch over
``batch_axes``.  Each rank attends over its own chunk and returns the
partial (max, numerator, denominator); the chunks combine by the
LSE-weighted sum of FlashDecoding's split-K reduction: an all-reduce MAX
of the running max, then SUMs of the rescaled numerator and denominator.

One process per rank: the core takes this rank's pieces (its batch rows,
its chunk of the cache) and writes the new token's K/V into its chunk IN
PLACE, only on the rank whose chunk holds ``pos`` (at ``pos - offset``),
as the port's single-device decode writes its cache.  A chunk holding no
position at or below ``pos`` has an empty softmax: its max is ``NEG_INF``,
its terms are rescaled by ``exp(m - m_glob) = 0``, and the ``1e-30`` on
the denominator keeps the combine finite, as in the reference.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from ..models import layers
from .collectives import _dims_group
from .sharding import axis_size, check_mesh_device


def make_decode_core(mesh, batch_axes: Sequence[str], seq_axes: Sequence[str], seq_len: int,
                     device=None):
    """``decode_core(q, k_new, v_new, ck, cv, pos) -> o`` over ``mesh``
    (every rank calls it): q (B_local, H, hd), k_new / v_new (B_local, KV,
    hd), this rank's cache chunk ck / cv (B_local, seq_len / n_seq, KV,
    hd), ``pos`` the global position (an int or a 0-d tensor); returns o
    (B_local, H, hd) in q's dtype.  ``batch_axes`` split the batch (the
    caller hands each rank its rows), ``seq_axes`` the cache's sequence
    (chunk i of the ranks' row-major order over ``seq_axes`` holds
    positions [i * local, (i + 1) * local)).  A mesh dimension in neither
    set sees replicated work.  ``device`` is the card unless the caller
    passes ``"cpu"`` (the device rule)."""
    check_mesh_device(mesh, device)
    seq_axes = tuple(seq_axes)
    n_seq = axis_size(mesh, seq_axes)
    if seq_len % n_seq:
        raise ValueError(f"seq_len={seq_len} not divisible by seq shards {n_seq}")
    local_len = seq_len // n_seq
    group = _dims_group(mesh, seq_axes)
    offset = dist.get_rank(group) * local_len

    def decode_core(q, k_new, v_new, ck, cv, pos):
        if ck.shape[1] != local_len:
            raise ValueError(f"cache chunk of {ck.shape[1]} entries, expected {local_len}")
        pos = torch.as_tensor(pos, device=q.device).long().reshape(())
        # a select on the one-token slice, no host read of pos: the rank
        # that owns pos writes the new entry, the others rewrite their own
        mine = (pos >= offset) & (pos < offset + local_len)
        at = (pos - offset).clamp(0, local_len - 1).reshape(1)
        for c, new in ((ck, k_new), (cv, v_new)):
            c.index_copy_(1, at, torch.where(mine, new[:, None], c.index_select(1, at)))
        num, den, m = layers.decode_attention_local(q, ck, cv, shard_offset=offset,
                                                    kv_len=pos + 1)
        m_glob = m.clone()
        dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
        scale = torch.exp(m - m_glob)
        # the rescaled numerator and denominator summed in one all-reduce
        parts = torch.cat([num * scale[..., None], (den * scale)[..., None]], dim=-1)
        dist.all_reduce(parts, group=group)
        return (parts[..., :-1] / (parts[..., -1:] + 1e-30)).to(q.dtype)

    decode_core.seq_len = seq_len
    decode_core.local_len = local_len
    decode_core.offset = offset
    return decode_core
