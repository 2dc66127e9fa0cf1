"""First-stage candidate generation and candidate-restricted retrieval —
port of the dual-encoder part of ``repro/core/candidates.py``.

- :class:`DualEncoderCandidates`: a dual-encoder dot-product shortlist over
  the corpus embeddings through the fused ``approx_topk`` op (the CUDA
  kernel on the card, k up to 1024), the (N, d) embeddings held as a
  (d, N) payload so no (B, N) score matrix is formed;
- :func:`candidate_eligibility`: a batch's shortlists as the engine's
  ``eligible`` mask;
- :class:`HybridRetriever`: first-stage shortlist -> ADACUR restricted to
  each query's own candidates (``mode="mask"``).

Candidate generation spends no CE calls: the engine still scores exactly
``ce_call_plan`` pairs a query.  BM25 (``BM25Candidates``,
``lexical_signatures``), ``OracleCandidates``, ``union_candidates`` and the
subset mode are not ported yet (ROADMAP.md, queue 1, item 3).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional, Protocol, runtime_checkable

import torch

from ..configs.base import AdaCURConfig
from ..kernels.approx_topk.ops import approx_topk_op
from . import prng
from .adacur import AdaCURResult, ScoreFn
from .engine import _IndexBacked, ce_call_plan, make_engine


@dataclass
class GeneratorStats:
    """Measured first-stage accounting."""

    requests: int = 0        # generator invocations observed
    candidates: int = 0      # candidate slots returned

    def copy(self) -> "GeneratorStats":
        return dataclasses.replace(self)

    def __sub__(self, other: "GeneratorStats") -> "GeneratorStats":
        return GeneratorStats(requests=self.requests - other.requests,
                              candidates=self.candidates - other.candidates)


@runtime_checkable
class CandidateGenerator(Protocol):
    """First-stage provider: query batch -> (B, k) candidate positions
    (corpus positions, best first, inside ``[0, n_valid)``)."""

    stats: GeneratorStats

    def __call__(self, query, k: int) -> torch.Tensor: ...


@dataclass
class DualEncoderCandidates:
    """Dual-encoder dot-product shortlist through the fused approx_topk op.
    ``i_emb`` (N, d) is held transposed as a (d, N) payload, streamed tile
    by tile like an anchor payload; exact ties break by ascending position
    (the op's contract)."""

    q_emb: torch.Tensor                 # (n_queries, d)
    i_emb: torch.Tensor                 # (N, d)
    n_valid: Optional[int] = None       # static valid-prefix bound
    tile: int = 1024                    # the plain version's item tile
    stats: GeneratorStats = field(default_factory=GeneratorStats)

    def __post_init__(self):
        self._i_emb_t = self.i_emb.to(torch.float32).t().contiguous()      # (d, N)
        self._q_emb = self.q_emb.to(device=self._i_emb_t.device, dtype=torch.float32)

    def reset_stats(self) -> None:
        self.stats = GeneratorStats()

    def __call__(self, query, k: int) -> torch.Tensor:
        qids = torch.as_tensor(query, device=self._q_emb.device).long()
        self.stats.requests += 1
        self.stats.candidates += int(qids.shape[0]) * k
        _, idx = approx_topk_op(self._q_emb[qids], self._i_emb_t, None, k, tile=self.tile,
                                n_valid=self.n_valid)
        return idx


def candidate_eligibility(cand: torch.Tensor, n_items: int,
                          per_query: bool = True) -> torch.Tensor:
    """(B, M) candidate positions -> the engine's ``eligible`` mask: (B, N)
    with each row's own shortlist when ``per_query``, else the (N,) batch
    union.  Positions outside [0, N) drop."""
    b = cand.shape[0]
    c = cand.long()
    c = torch.where((c >= 0) & (c < n_items), c, n_items)
    if per_query:
        out = torch.zeros((b, n_items + 1), dtype=torch.bool, device=cand.device)
        return out.scatter_(1, c, True)[:, :n_items].contiguous()
    out = torch.zeros(n_items + 1, dtype=torch.bool, device=cand.device)
    return out.scatter_(0, c.reshape(-1), True)[:n_items]


@dataclass
class HybridRetriever(_IndexBacked):
    """First-stage shortlist -> ADACUR over each query's own candidates.

    ``mode="mask"``: the engine runs over the full corpus with a per-query
    ``eligible`` mask, so row i never spends budget on row j's candidates.
    ``mode="subset"`` (the reference's compact sub-index with ``pos_map``)
    is not ported yet.  ``shortlist_k`` must cover ``budget_ce``, or the
    engine would sample ineligible items."""

    score_fn: ScoreFn
    generator: Callable
    cfg: AdaCURConfig
    r_anc: Optional[object] = None
    index: Optional[object] = None       # repro_torch.core.index.AnchorIndex
    shortlist_k: int = 0
    mode: str = "mask"
    _run: Callable = field(init=False, repr=False)

    def __post_init__(self):
        if self.r_anc is None and self.index is None:
            raise ValueError("need r_anc or an AnchorIndex")
        if self.mode == "subset":
            raise NotImplementedError(
                "HybridRetriever(mode='subset') (union_candidates, pos_map) is not "
                "ported yet (ROADMAP.md, queue 1, item 3); use mode='mask'")
        if self.mode != "mask":
            raise ValueError(f"unknown mode '{self.mode}' (subset|mask)")
        if self.shortlist_k < self.cfg.budget_ce:
            raise ValueError(
                f"shortlist_k={self.shortlist_k} < budget_ce={self.cfg.budget_ce}: every "
                "query must propose at least budget_ce candidates or the engine would "
                "sample ineligible items")
        self._apply_payload_policy(self.cfg)
        self._run = make_engine(self.score_fn, self.cfg)

    def ce_call_plan(self, rounds: Optional[int] = None) -> int:
        """Planned CE calls per query: the engine's plan, the first stage free."""
        return ce_call_plan(self.cfg, rounds)

    def search(self, query, key=None, n_rounds=None, **_ignored) -> AdaCURResult:
        key = prng.PRNGKey(0) if key is None else key
        cand = self.generator(query, self.shortlist_k)
        query = self._prep_query(query)
        r_anc, kw = self._search_operands()
        eligible = candidate_eligibility(cand.to(r_anc.device), r_anc.shape[1])
        return self._run(r_anc, query, key, n_rounds=n_rounds, eligible=eligible, **kw)
