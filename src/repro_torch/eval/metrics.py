"""Retrieval quality metrics — port of ``topk_recall`` from
``repro/eval/metrics.py`` (the qrels metrics are a later slice)."""

from __future__ import annotations

import torch

from ..kernels.approx_topk.select import stable_topk


def exact_topk(exact_scores: torch.Tensor, k: int):
    """Ground-truth top-k under the cross-encoder (index-stable)."""
    return stable_topk(exact_scores.to(torch.float32), k)


def topk_recall(retrieved_idx: torch.Tensor, gt_idx: torch.Tensor, k: int) -> float:
    """Top-k-Recall: |retrieved ∩ gt_topk| / k, averaged over the batch."""
    gt = gt_idx[:, :k].to(retrieved_idx.device, torch.int64)
    hits = (retrieved_idx.long()[:, :, None] == gt[:, None, :]).any(dim=1)
    return hits.to(torch.float32).mean().item()
