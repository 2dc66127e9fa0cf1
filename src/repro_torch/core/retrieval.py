"""Budget-matched retrieve-and-rerank — port of
``repro/core/retrieval.py::rerank_baseline``.

Every method of the paper's comparison is given the same test-time budget
of exact CE calls: a retrieve-and-rerank baseline (dual-encoder, TF-IDF)
spends the whole budget re-ranking its own top candidates.  The recall
metrics live in :mod:`repro_torch.eval.metrics`.
"""

from __future__ import annotations

import torch

from ..kernels.approx_topk.select import stable_topk
from .adacur import AdaCURResult, ScoreFn


def rerank_baseline(score_fn: ScoreFn, candidate_idx: torch.Tensor, query, budget_ce: int,
                    k_retrieve: int) -> AdaCURResult:
    """Exact-CE-score the top ``budget_ce`` candidates of any first-stage
    retriever and rank them (index-stable, ties to the earlier candidate)."""
    cand = candidate_idx[:, :budget_ce]
    scores = score_fn(query, cand).to(torch.float32)
    top_s, top_pos = stable_topk(scores, min(k_retrieve, cand.shape[1]))
    top_idx = torch.gather(cand, 1, top_pos.long())
    return AdaCURResult(cand, scores, scores, top_idx, top_s, budget_ce)
