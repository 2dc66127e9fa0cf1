"""Dense oracle — port of ``repro/kernels/approx_topk/ref.py``: materialize
S_hat, mask, one index-stable top-k over all N columns."""

from __future__ import annotations

import torch

from .ops import anchor_mask
from .quant import matmul
from .select import NEG_INF, stable_topk


def dense_scores(e_q, r_anc, anchors=None, noise=None, mask=None, n_valid=None):
    """(B, N) fp32 ``e_q @ R_anc (+ noise)`` with every suppressed entry
    (anchor ids, ``mask``, columns at or past ``n_valid``) at ``NEG_INF``."""
    scores = matmul(e_q, r_anc)
    if noise is not None:
        scores = scores + noise.to(torch.float32)
    b, n = scores.shape
    hit = torch.zeros((b, n), dtype=torch.bool, device=scores.device)
    if anchors is not None:
        hit |= anchor_mask(anchors, b, n, scores.device)
    if mask is not None:
        hit |= mask
    if n_valid is not None:
        hit |= (torch.arange(n, device=scores.device) >= n_valid)[None, :]
    return torch.where(hit, torch.tensor(NEG_INF, device=scores.device), scores)


def approx_topk_reference(e_q, r_anc, anchors, k: int, noise=None, mask=None,
                          n_valid=None):
    return stable_topk(dense_scores(e_q, r_anc, anchors, noise, mask, n_valid), k)
