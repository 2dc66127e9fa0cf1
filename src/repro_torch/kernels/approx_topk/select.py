"""Index-stable top-k selection in plain torch.

Every ``lax.top_k`` of the reference is index-stable: equal values go to
the lower index.  ``torch.topk`` is not (its tie order is unspecified), so
the port selects by one composite int64 key per entry — the float's
order-preserving integer image in the high 32 bits and the complemented id
in the low 32 — which makes every key unique.  ``torch.topk`` over unique
keys has exactly one answer: (max value, min id) first, the rule of the
reference's ``_select_min_id`` and of its index-stable merges.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
INT32_MAX = 2**31 - 1
_M32 = 0xFFFFFFFF
# entries per selection chunk: three int64 temporaries of ~256 MB each
_CHUNK = 1 << 25


def _keys(vals: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    bits = vals.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    return ordered * (1 << 32) + (_M32 - ids.to(torch.int64))


def topk_value_id(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Top-k of (value, id) pairs along dim 1 by (max value, min id).

    ``vals`` (R, M) float32, ``ids`` (R, M) or (M,) non-negative int32
    ids -> (values (R, k) float32, ids (R, k) int32), best first."""
    r, m = vals.shape
    if ids.dim() == 1:
        ids = ids.expand(r, m)
    step = max(1, _CHUNK // max(1, m))
    out_v, out_i = [], []
    for lo in range(0, r, step):
        v = vals[lo:lo + step]
        key = _keys(v, ids[lo:lo + step])
        _, pos = torch.topk(key, k, dim=1)
        out_v.append(torch.gather(v, 1, pos).to(torch.float32))
        out_i.append(torch.gather(ids[lo:lo + step], 1, pos).to(torch.int32))
    return torch.cat(out_v), torch.cat(out_i)


def stable_topk(x: torch.Tensor, k: int):
    """Index-stable ``lax.top_k(x, k)`` along dim 1 -> (values, int32 ids)."""
    ids = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return topk_value_id(x, ids, k)
