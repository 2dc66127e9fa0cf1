"""Gradient compression for the cross-pod reduction — port of
``repro/distributed/compression.py``.

Two compressors, both with error feedback (the residual re-enters the
next step's gradient, so nothing is lost over steps):

- int8: a per-tensor absmax scale, a quarter of fp32's bytes;
- top-k: keep the largest ``frac`` of |g| per tensor.

They are value transformations of tensors and of parameter trees
(``repro_torch.tree``), wrapped around whatever reduction a step does.

The codes are the reference's bits: ``torch.round`` rounds half to even
as ``jnp.round`` does, and the division and clip are the same fp32 ops.
The top-k threshold is the k-th largest |g| through the index-stable
``select.stable_topk`` (``lax.top_k``'s order), so the kept set is the
reference's, ties at the threshold included.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..kernels.approx_topk.select import stable_topk
from ..tree import leaves, tree_map, unflatten_like


def int8_codes(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 ``g`` over ``scale``, rounded half to even, clipped to ±127."""
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def int8_quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, fp32 scale) with ``scale = max|g| / 127 + 1e-12``."""
    g = g.to(torch.float32)
    scale = g.abs().max() / 127.0 + 1e-12
    return int8_codes(g, scale), scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _map_pairs(one, grads, error):
    """``one(g, e) -> (a, b)`` over matching leaves -> (tree of a, tree of b)."""
    outs = [one(g, e) for g, e in zip(leaves(grads), leaves(error))]
    return (unflatten_like(grads, [a for a, _ in outs]),
            unflatten_like(grads, [b for _, b in outs]))


def int8_roundtrip_with_feedback(grads, error):
    """(grads compressed to int8 and back, new error residual): the codes
    are what would cross the pod link; the residual feeds the next step."""
    def one(g, e):
        g = g.to(torch.float32) + e
        q, s = int8_quantize(g)
        deq = int8_dequantize(q, s)
        return deq, g - deq

    return _map_pairs(one, grads, error)


def topk_threshold(g: torch.Tensor, frac: float) -> torch.Tensor:
    """The k-th largest |g| (k = max(1, int(numel * frac))), as
    ``lax.top_k`` ranks it."""
    k = max(1, int(g.numel() * frac))
    return stable_topk(g.abs().reshape(1, -1), k)[0][0, -1]


def topk_sparsify_with_feedback(grads, error, frac: float = 0.01):
    """Keep each tensor's entries with |g| at or above its top-``frac``
    threshold; the rest feeds back."""
    def one(g, e):
        g = g.to(torch.float32) + e
        kept = torch.where(g.abs() >= topk_threshold(g, frac), g, torch.zeros((), device=g.device))
        return kept, g - kept

    return _map_pairs(one, grads, error)


def init_error_feedback(params) -> Any:
    """fp32 zeros shaped like every leaf of ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
