"""IR evaluation harness: budget-matched quality matrices over retrievers —
port of ``repro/eval/harness.py``.

:func:`quality_matrix` runs the paper's comparison in one call: ADACUR vs
ANNCUR vs dual-encoder retrieve-and-rerank vs the DE-hybrid and, given
token data, the BM25-hybrid (a first-stage shortlist -> candidate-restricted
ADACUR), every method at the same exact-CE-call budget, each with its own
:class:`~repro_torch.core.scorer.TabulatedScorer` so every spend is
measured and held against the engine's plan.

Two deliberate differences from the reference: ANNCUR and rerank get the
matrix's config as their ``base_cfg``, so ``use_fused_topk`` reaches their
engine too (the reference leaves them on the default, dense config; the ids
are the same either way, and on the card the fused path runs the kernel);
and rerank_de's dual-encoder candidates are computed inside its timed
window, as hybrid_de's are (the reference computes them before the clock
starts).  Each report also counts the kernel launches of its window.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from ..configs.base import AdaCURConfig
from ..core import prng
from ..core.candidates import BM25Candidates, DualEncoderCandidates, HybridRetriever
from ..core.engine import AdaCURRetriever, ANNCURRetriever, RerankRetriever
from ..core.scorer import TabulatedScorer, scorer_stats
from ..kernels import launch_counts
from .metrics import Qrels, evaluate_result, ir_metrics, qrels_from_exact


@dataclass
class MethodReport:
    """One method's row in a budget-matched quality matrix."""

    method: str
    planned_ce: int                        # engine plan, per query
    measured_ce: Optional[int] = None      # scorer-measured, per query
    budget_matched: Optional[bool] = None  # measured == planned
    topk_recall: Dict[int, float] = field(default_factory=dict)
    ir: Dict[str, float] = field(default_factory=dict)
    wall_us_per_query: float = 0.0
    launches: Dict[str, int] = field(default_factory=dict)   # kernel launches, by kernel

    def to_json(self) -> dict:
        d = asdict(self)
        d["topk_recall"] = {str(k): v for k, v in self.topk_recall.items()}
        return d


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


SearchKw = Union[None, dict, Callable[[torch.Tensor], dict]]


def evaluate_retriever(name: str, retriever, qids, key, *, exact=None,
                       qrels: Optional[Qrels] = None, ks: Sequence[int] = (1, 10, 100),
                       search_kw: SearchKw = None) -> MethodReport:
    """Run one retriever over the test split and score its ranking.

    ``exact`` (B, N) gives the paper's Top-k-Recall, ``qrels`` recall@k /
    MRR@k / NDCG@k.  When the retriever's ``score_fn`` is a Scorer, the CE
    spend of this window is measured and held against the plan.
    ``search_kw`` is a dict, or a function of the query ids that makes one
    inside the window (a first stage).  The wall time runs from the call to
    a device sync after it."""
    b = int(qids.shape[0])
    stats = scorer_stats(getattr(retriever, "score_fn", None))
    before = stats.copy() if stats is not None else None
    _sync(qids)
    launches0 = launch_counts()
    t0 = time.perf_counter()
    kw = search_kw(qids) if callable(search_kw) else (search_kw or {})
    res = retriever.search(qids, key, **kw)
    _sync(res.topk_idx)
    rep = MethodReport(method=name, planned_ce=int(res.ce_calls),
                       wall_us_per_query=(time.perf_counter() - t0) / b * 1e6)
    rep.launches = {k: v - launches0[k] for k, v in launch_counts().items()}
    if stats is not None:
        delta = stats - before
        rep.measured_ce = delta.ce_calls // b
        rep.budget_matched = delta.ce_calls == rep.planned_ce * b
    if exact is not None:
        rep.topk_recall = evaluate_result(name, res, exact, ks=ks).recall
    if qrels is not None:
        rep.ir = ir_metrics(res.topk_idx, qrels, ks=ks)
    return rep


def method_retrievers(ce, index, matrix, cfg: AdaCURConfig, shortlist_k: int,
                      seed: int = 0, corpus_tokens=None, query_tokens=None) -> list:
    """The matrix's methods at ``cfg``'s budget, each with its own
    TabulatedScorer over ``matrix``: (name, retriever, search_kw), the
    search_kw a dict or a function of the query ids.  Token data adds the
    BM25-hybrid, its weights on the matrix's device."""
    budget = cfg.budget_ce
    de = DualEncoderCandidates(ce.q_emb, ce.i_emb, n_valid=index.n_items)
    bm25 = []
    if corpus_tokens is not None and query_tokens is not None:
        bm = BM25Candidates(corpus_tokens, query_tokens, n_valid=index.n_items,
                            device=matrix.device)
        bm25 = [("hybrid_bm25", HybridRetriever(
            score_fn=TabulatedScorer(matrix), generator=bm, cfg=cfg, index=index,
            shortlist_k=shortlist_k, mode="mask"), None)]
    return [
        ("adacur", AdaCURRetriever.from_index(index, TabulatedScorer(matrix), cfg), None),
        ("anncur", ANNCURRetriever.from_index(
            index.with_anchors(k_anchor=cfg.k_anchor, key=prng.PRNGKey(seed + 1)),
            TabulatedScorer(matrix), budget, k_retrieve=cfg.k_retrieve, base_cfg=cfg), None),
        ("rerank_de", RerankRetriever.from_index(
            index, TabulatedScorer(matrix), budget, k_retrieve=cfg.k_retrieve, base_cfg=cfg),
            lambda q: dict(candidate_idx=de(q, budget))),
        ("hybrid_de", HybridRetriever(
            score_fn=TabulatedScorer(matrix), generator=de, cfg=cfg, index=index,
            shortlist_k=shortlist_k, mode="mask"), None),
    ] + bm25


def matrix_config(budget: int = 200, n_rounds: int = 5, ks: Sequence[int] = (1, 10, 100),
                  use_fused_topk: bool = False,
                  payload_dtype: str = "float32") -> AdaCURConfig:
    """The engine config of :func:`quality_matrix`: half the budget on
    anchors (a multiple of ``n_rounds``), TopK rounds, ``fori``."""
    k_anchor = max(n_rounds, (budget // 2) // n_rounds * n_rounds)
    return AdaCURConfig(k_anchor=k_anchor, n_rounds=n_rounds, budget_ce=budget,
                        strategy="topk", k_retrieve=max(ks), loop_mode="fori",
                        use_fused_topk=use_fused_topk, payload_dtype=payload_dtype)


def quality_matrix(ce, index, test_q, matrix, *, budget: int = 200, n_rounds: int = 5,
                   ks: Sequence[int] = (1, 10, 100), shortlist_k: Optional[int] = None,
                   qrels_k: int = 1, corpus_tokens=None, query_tokens=None, seed: int = 0,
                   use_fused_topk: bool = False) -> List[MethodReport]:
    """Budget-matched quality matrix over one synthetic CE domain:

    - ``adacur``     multi-round adaptive anchors (the paper's method)
    - ``anncur``     fixed anchors, one round (Yadav et al. 2022)
    - ``rerank_de``  dual-encoder retrieve-and-rerank (the whole budget reranks)
    - ``hybrid_de``  DE shortlist -> candidate-restricted ADACUR
    - ``hybrid_bm25`` BM25 shortlist -> candidate-restricted ADACUR (only
      when ``corpus_tokens`` and ``query_tokens`` are given)

    ``matrix`` is the (n_queries, N) exact score table (rows by global query
    id), on the device the search runs on; ``test_q`` the query ids.  The
    qrels are the CE's exact top-``qrels_k``."""
    test_q = torch.as_tensor(test_q, device=matrix.device)
    exact = matrix[test_q.long()]
    qrels = qrels_from_exact(exact, k=qrels_k)
    if shortlist_k is None:
        shortlist_k = min(4 * budget, index.n_items)
    if shortlist_k < budget:
        raise ValueError(f"shortlist_k={shortlist_k} < budget={budget}")
    cfg = matrix_config(budget, n_rounds, ks, use_fused_topk)
    key = prng.PRNGKey(seed)
    return [evaluate_retriever(name, ret, test_q, key, exact=exact, qrels=qrels, ks=ks,
                               search_kw=kw)
            for name, ret, kw in method_retrievers(ce, index, matrix, cfg, shortlist_k, seed,
                                                   corpus_tokens, query_tokens)]
