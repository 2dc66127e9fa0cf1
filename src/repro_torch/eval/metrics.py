"""Retrieval quality metrics — port of ``repro/eval/metrics.py``: the
paper's Top-k-Recall and the standard IR measures (recall@k, MRR@k,
NDCG@k) over explicit relevance judgments (qrels).

- **Top-k-Recall** (paper §3): the fraction of the cross-encoder's exact
  top-k found in the method's returned set, ground truth from the exact
  score matrix through the port's index-stable top-k.
- **qrels metrics**: recall@k / MRR@k / NDCG@k against per-query judgments
  (gold labels, CE-top-k pseudo-labels or graded gains), computed on the
  host in float64 as the reference does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Sequence, Union

import numpy as np
import torch

from ..kernels.approx_topk.select import stable_topk

# per-query relevance: {item_id: gain} (graded) or a set of ids (binary)
Qrels = Sequence[Union[Mapping[int, float], frozenset, set]]


def exact_topk(exact_scores: torch.Tensor, k: int):
    """Ground-truth top-k under the cross-encoder (index-stable)."""
    return stable_topk(exact_scores.to(torch.float32), k)


def topk_recall(retrieved_idx: torch.Tensor, gt_idx: torch.Tensor, k: int) -> float:
    """Top-k-Recall: |retrieved ∩ gt_topk| / k, averaged over the batch."""
    gt = gt_idx[:, :k].to(retrieved_idx.device, torch.int64)
    hits = (retrieved_idx.long()[:, :, None] == gt[:, None, :]).any(dim=1)
    return hits.to(torch.float32).mean().item()


@dataclass
class RecallReport:
    method: str
    budget_ce: int
    recall: dict  # k -> float


def evaluate_result(method: str, result, exact_scores: torch.Tensor,
                    ks=(1, 10, 100)) -> RecallReport:
    """Paper-protocol report of an engine result (``.topk_idx``,
    ``.ce_calls``); the ground truth is one top-``max(ks)``, whose prefixes
    are the smaller top-ks."""
    _, gt = exact_topk(exact_scores, max(ks))
    idx = result.topk_idx.to(gt.device)
    return RecallReport(method, result.ce_calls, {k: topk_recall(idx, gt, k) for k in ks})


def qrels_from_exact(exact_scores, k: int = 1) -> Qrels:
    """Pseudo-qrels from the CE's exact top-k: the judgment set every
    budget-limited method tries to recover (``k=1``: gold-style single
    relevant item, recall@k == accuracy@k)."""
    _, gt = exact_topk(torch.as_tensor(exact_scores), k)
    return [frozenset(int(i) for i in row) for row in gt.cpu().tolist()]


def qrels_from_gold(gold) -> Qrels:
    """Qrels from a (B,) gold item-id vector (entity-linking labels)."""
    return [frozenset((int(g),)) for g in np.asarray(torch.as_tensor(gold).cpu())]


def _gains(rel) -> Dict[int, float]:
    if isinstance(rel, (set, frozenset)):
        return {int(i): 1.0 for i in rel}
    return {int(i): float(g) for i, g in rel.items()}


def ir_metrics(ranked, qrels: Qrels, ks: Sequence[int] = (1, 10, 100)) -> Dict[str, float]:
    """recall@k / MRR@k / NDCG@k of a ranked retrieval, batch-averaged.

    ``ranked``: (B, R) item ids in descending relevance order.  Queries with
    empty judgments are skipped; a duplicate id in a row (the engine pads
    an under-filled ranking by repeating the row-best) counts once, at its
    first position."""
    ranked = np.asarray(ranked.cpu() if isinstance(ranked, torch.Tensor) else ranked)
    if ranked.ndim != 2 or len(qrels) != ranked.shape[0]:
        raise ValueError(f"ranked {ranked.shape} does not match {len(qrels)} qrels rows")
    sums = {f"{m}@{k}": 0.0 for k in ks for m in ("recall", "mrr", "ndcg")}
    n_eval = 0
    for row, rel in zip(ranked, qrels):
        gains = _gains(rel)
        if not gains:
            continue
        n_eval += 1
        seen = set()
        hits = []                       # (position, gain) of first occurrences
        for pos, item in enumerate(row):
            item = int(item)
            if item in seen:
                continue
            seen.add(item)
            if item in gains:
                hits.append((pos, gains[item]))
        ideal = sorted(gains.values(), reverse=True)
        for k in ks:
            in_k = [(p, g) for p, g in hits if p < k]
            sums[f"recall@{k}"] += len(in_k) / len(gains)
            sums[f"mrr@{k}"] += 1.0 / (in_k[0][0] + 1) if in_k else 0.0
            dcg = sum(g / math.log2(p + 2) for p, g in in_k)
            idcg = sum(g / math.log2(i + 2) for i, g in enumerate(ideal[:k]))
            sums[f"ndcg@{k}"] += dcg / idcg if idcg > 0 else 0.0
    if n_eval == 0:
        raise ValueError("every qrels row is empty — nothing to evaluate")
    return {name: v / n_eval for name, v in sums.items()}
