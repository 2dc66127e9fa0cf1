"""First-stage candidate generation and candidate-restricted retrieval —
port of ``repro/core/candidates.py``.

- Providers (:class:`CandidateGenerator`): a dual-encoder dot-product
  shortlist through the fused ``approx_topk`` op (the CUDA kernel on the
  card, k up to 1024; :class:`DualEncoderCandidates`), a BM25 sparse-lexical
  shortlist (:class:`BM25Candidates`: one folded (N, V) weight matrix, a
  plain fp32 product, a stable descending order) and the exact-score
  oracle (:class:`OracleCandidates`), each counting its requests and
  candidates;
- candidate-subset search: :func:`union_candidates` unions a batch's
  shortlists into a sorted, padded position vector, the payload columns
  there are gathered into a compact sub-payload (``quant.subset_columns``:
  coded payloads keep their code bytes, per-column scales) and the engine
  runs over it with ``pos_map`` remapping every noise draw to corpus
  coordinates, which makes it bit-equal to the same search over the full
  corpus masked to the union;
- :class:`HybridRetriever`: first stage -> ADACUR over the candidates,
  ``mode="subset"`` (the compact sub-payload, the default) or
  ``mode="mask"`` (each query restricted to its own shortlist over the full
  corpus through the engine's ``eligible`` operand).

Candidate generation spends no CE calls: the engine still scores exactly
``ce_call_plan`` pairs a query.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from ..configs.base import AdaCURConfig
from ..device import resolve_device
from ..kernels.approx_topk import quant
from ..kernels.approx_topk.ops import approx_topk_op
from ..kernels.approx_topk.select import stable_topk
from . import prng
from .adacur import AdaCURResult, ScoreFn
from .engine import _IndexBacked, ce_call_plan, engine_search


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


def _term_counts(tokens: torch.Tensor, vocab: int, pad_id: int) -> torch.Tensor:
    """(R, L) token ids -> (R, vocab) fp32 term counts, the pad id zeroed."""
    tf = torch.zeros((tokens.shape[0], vocab), dtype=torch.float32, device=tokens.device)
    tf.scatter_add_(1, tokens.long(), torch.ones(tokens.shape, dtype=torch.float32,
                                                 device=tokens.device))
    tf[:, pad_id] = 0.0
    return tf


class BM25Candidates:
    """BM25 sparse-lexical shortlist.

    The corpus statistics fold at construction into one (N, V) weight matrix
    ``W[d, t] = idf[t] * tf[d, t] * (k1 + 1) / (tf[d, t] + k1 * (1 - b +
    b * dl[d] / avgdl))`` (Robertson/Sparck-Jones BM25), on ``device`` (the
    card unless ``device="cpu"``), so scoring a query batch is one fp32
    product ``qtf @ W.T`` over its term counts (a plain product, TF32 off;
    not one of the TPU kernels).  The order is a stable descending one,
    ties to the lower position, as the reference's
    ``np.argsort(kind="stable")``; positions from ``n_valid`` on are
    never returned.  Every call counts its requests and candidates."""

    def __init__(self, corpus_tokens, query_tokens, k1: float = 1.5, b: float = 0.75,
                 pad_id: int = 0, n_valid: Optional[int] = None, device=None):
        dev = resolve_device(device)
        corpus = torch.as_tensor(np.asarray(corpus_tokens)).to(dev)
        self.query_tokens = torch.as_tensor(np.asarray(query_tokens)).to(dev)
        self.pad_id = pad_id
        self.stats = GeneratorStats()
        n_docs = corpus.shape[0]
        self.n_valid = n_docs if n_valid is None else int(n_valid)
        self.vocab = int(max(int(corpus.max()), int(self.query_tokens.max()))) + 1
        tf = _term_counts(corpus, self.vocab, pad_id)
        dl = tf.sum(dim=1)
        # the counts are exact in fp32, so this is numpy's float32 mean
        avgdl = max(float(dl[:self.n_valid].double().sum().float() / self.n_valid), 1e-9)
        df = (tf[:self.n_valid] > 0).sum(dim=0).to(torch.float32)
        idf = torch.log(1.0 + (self.n_valid - df + 0.5) / (df + 0.5))
        # a tensor divisor: CUDA divides by a Python scalar as a multiply by
        # its reciprocal, an ulp away from numpy's division
        avgdl = torch.tensor(avgdl, dtype=torch.float32, device=dev)
        denom = tf + k1 * ((1.0 - b) + b * dl[:, None] / avgdl)
        w = idf[None, :] * tf * (k1 + 1.0) / denom
        self._w = torch.where(tf > 0, w, 0.0)                   # (N, V)

    def reset_stats(self) -> None:
        self.stats = GeneratorStats()

    def __call__(self, query, k: int) -> torch.Tensor:
        qids = torch.as_tensor(query, device=self._w.device).long()
        self.stats.requests += 1
        self.stats.candidates += int(qids.shape[0]) * k
        qtf = _term_counts(self.query_tokens[qids], self.vocab, self.pad_id)
        scores = qtf @ self._w.T                                # (B, N)
        scores[:, self.n_valid:] = -float("inf")
        return stable_topk(scores, k)[1]


@dataclass
class OracleCandidates:
    """Candidates from the exact CE score matrix: a first stage with perfect
    recall@k, for tests and for isolating the engine's share of hybrid
    quality.  Index-stable order."""

    exact_scores: torch.Tensor          # (n_queries, N)
    n_valid: Optional[int] = None
    stats: GeneratorStats = field(default_factory=GeneratorStats)

    def reset_stats(self) -> None:
        self.stats = GeneratorStats()

    def __call__(self, query, k: int) -> torch.Tensor:
        qids = torch.as_tensor(query, device=self.exact_scores.device).long()
        self.stats.requests += 1
        self.stats.candidates += int(qids.shape[0]) * k
        s = self.exact_scores[qids]
        if self.n_valid is not None and self.n_valid < s.shape[1]:
            s = torch.where(torch.arange(s.shape[1], device=s.device) < self.n_valid, s,
                            -float("inf"))
        return stable_topk(s, k)[1]


# ---------------------------------------------------------------------------
# Candidate-subset machinery
# ---------------------------------------------------------------------------


def union_candidates(cand: torch.Tensor, capacity: int, n_corpus: int):
    """Sorted union of a batch's candidate positions, padded to ``capacity``
    -> ``(pos, valid, n_sub)``: ``pos`` (capacity,) int32 ascending with the
    padded slots at position 0 (``valid`` False there), ``n_sub`` the union's
    size (a 0-d tensor).  Entries >= ``n_corpus`` are padding; a union larger
    than ``capacity`` drops its largest positions (size the capacity to
    ``B * shortlist_k``, as :class:`HybridRetriever` does)."""
    u = torch.unique(cand.to(torch.int64).reshape(-1))[:capacity]
    if u.shape[0] < capacity:
        u = torch.cat([u, torch.full((capacity - u.shape[0],), n_corpus,
                                     dtype=u.dtype, device=u.device)])
    n_sub = (u < n_corpus).sum().to(torch.int32)
    valid = torch.arange(capacity, device=u.device) < n_sub
    pos = torch.where(valid, u, 0).to(torch.int32)
    return pos, valid, n_sub


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
    """First-stage shortlist -> ADACUR over the candidates.

    ``mode="subset"`` (default): the batch's shortlists are unioned and
    their payload columns gathered into a compact sub-payload; the engine
    then streams C = O(B * shortlist_k) columns a round instead of N, with
    ``pos_map`` keeping every noise draw on corpus coordinates (bit-equal to
    the full-corpus search masked to the union).  ``mode="mask"``: each
    query is restricted to its own shortlist over the full corpus through
    the engine's per-query ``eligible`` mask (row i never spends budget on
    row j's candidates).  Either way the CE plan is the engine's, the first
    stage free, and ``shortlist_k`` must cover ``budget_ce``, or the engine
    would sample ineligible items."""

    score_fn: ScoreFn
    generator: Callable
    cfg: AdaCURConfig
    r_anc: Optional[object] = None
    index: Optional[object] = None       # repro_torch.core.index.AnchorIndex
    shortlist_k: int = 0
    mode: str = "subset"
    _run: Callable = field(init=False, repr=False)

    def __post_init__(self):
        if self.r_anc is None and self.index is None:
            raise ValueError("need r_anc or an AnchorIndex")
        if self.mode not in ("subset", "mask"):
            raise ValueError(f"unknown mode '{self.mode}' (subset|mask)")
        if self.shortlist_k < self.cfg.budget_ce:
            raise ValueError(
                f"shortlist_k={self.shortlist_k} < budget_ce={self.cfg.budget_ce}: every "
                "query must propose at least budget_ce candidates or the engine would "
                "sample ineligible items")
        self._apply_payload_policy(self.cfg)
        if self.r_anc is not None:
            # the policy applied once, so a subset gathers the payload a
            # full-corpus search would stream
            self.r_anc = quant.as_payload(self.r_anc, self.cfg.payload_dtype,
                                          self.cfg.payload_tile)
        sharded = self.index is not None and self.index._item_sharding()[0] is not None
        if self.mode == "subset" and sharded:
            raise ValueError("mode='subset' is single-device (pos_map); use mode='mask' "
                             "over a sharded index")
        self._run = self._subset_run if self.mode == "subset" else self._build_engine(self.cfg)

    def ce_call_plan(self, rounds: Optional[int] = None) -> int:
        """Planned CE calls per query: the engine's plan, the first stage free."""
        return ce_call_plan(self.cfg, rounds)

    def _operands(self):
        """(payload, item_ids (capacity,), n_valid)."""
        if self.index is not None:
            return self.index.r_anc, self.index.item_ids, self.index.n_valid
        n = self.r_anc.shape[1]
        dev = self.r_anc.device
        return self.r_anc, torch.arange(n, dtype=torch.int32, device=dev), n

    def _capacity(self, b: int) -> int:
        """The sub-payload's static width: every shortlist slot of the batch
        (and at least the budget and k_retrieve), in 128-column steps."""
        full = self.index.capacity if self.index is not None else self.r_anc.shape[1]
        want = max(b * self.shortlist_k, self.cfg.budget_ce, self.cfg.k_retrieve)
        return min(-(-want // 128) * 128, full)

    def _subset_run(self, query, cand, key, n_rounds) -> AdaCURResult:
        r_anc, item_ids, n_valid = self._operands()
        n_full = r_anc.shape[1]
        dev = item_ids.device
        cand = cand.to(device=dev, dtype=torch.int64)
        # positions outside the valid prefix become padding
        cand = torch.where(cand < torch.as_tensor(n_valid, device=dev), cand, n_full)
        pos, valid, n_sub = union_candidates(cand, self._capacity(cand.shape[0]), n_full)
        sub = quant.subset_columns(r_anc, pos, valid)
        sub_ids = torch.where(valid, item_ids[pos.long()], -1)
        res = engine_search(self.score_fn, sub, query, self.cfg, key, n_valid_items=n_sub,
                            n_rounds=n_rounds, return_scores=False, item_ids=sub_ids,
                            pos_map=pos)
        # results leave in corpus positions, like every retriever's
        anchor = res.anchor_idx.long()
        return dataclasses.replace(
            res, anchor_idx=torch.where(anchor >= 0, pos[anchor.clamp_min(0)], -1),
            topk_idx=pos[res.topk_idx.long()])

    def search(self, query, key=None, n_rounds=None, **_ignored) -> AdaCURResult:
        key = prng.PRNGKey(0) if key is None else key
        if n_rounds is not None and self.cfg.loop_mode != "fori":
            raise ValueError("runtime n_rounds override requires loop_mode='fori'")
        cand = self.generator(query, self.shortlist_k)
        query = self._prep_query(query)
        if self.mode == "subset":
            return self._run(query, cand, key, n_rounds)
        r_anc, kw = self._search_operands()
        n = self.index.capacity if self.index is not None else r_anc.shape[1]
        eligible = candidate_eligibility(cand.to(r_anc.device), n)
        return self._run(r_anc, query, key, n_rounds=n_rounds, eligible=eligible, **kw)
