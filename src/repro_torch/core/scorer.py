"""Cross-encoder scorers with measured CE-call accounting — port of the
``ScorerStats``/``SyntheticScorer``/``TabulatedScorer`` part of
``repro/core/scorer.py``.

The port runs eagerly, so every scorer counts ``ce_calls`` as the calls
happen (the reference's pure-traced ``SyntheticScorer`` cannot).
``record_pairs=True`` keeps a log of every scored (query ids, item ids)
batch, from which a test reconstructs each search's scored-pair multiset.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch


@dataclass
class ScorerStats:
    requests: int = 0        # score() invocations
    pairs: int = 0           # (query, item) pairs requested
    ce_calls: int = 0        # pairs scored by the underlying model
    cache_hits: int = 0
    cache_size: int = 0
    batch_pad: int = 0

    def copy(self) -> "ScorerStats":
        return dataclasses.replace(self)

    def __sub__(self, other: "ScorerStats") -> "ScorerStats":
        return ScorerStats(
            requests=self.requests - other.requests,
            pairs=self.pairs - other.pairs,
            ce_calls=self.ce_calls - other.ce_calls,
            cache_hits=self.cache_hits - other.cache_hits,
            cache_size=self.cache_size,
            batch_pad=self.batch_pad - other.batch_pad,
        )


def scorer_stats(score_fn) -> Optional[ScorerStats]:
    """The live stats of a ScoreFn if it is a Scorer, else None."""
    s = getattr(score_fn, "stats", None)
    return s if isinstance(s, ScorerStats) else None


class _CountingScorer:
    def __init__(self, record_pairs: bool = False):
        self.stats = ScorerStats()
        self.record_pairs = record_pairs
        self.call_log: List[Tuple[np.ndarray, np.ndarray]] = []

    def reset_stats(self) -> None:
        self.stats = ScorerStats()
        self.call_log = []

    def _count(self, query, item_idx) -> None:
        n = int(item_idx.numel())
        self.stats.requests += 1
        self.stats.pairs += n
        self.stats.ce_calls += n
        if self.record_pairs:
            self.call_log.append((query.detach().cpu().numpy().copy(),
                                  item_idx.detach().cpu().numpy().copy()))


class SyntheticScorer(_CountingScorer):
    """The closed-form synthetic CE, scored on the domain's device."""

    def __init__(self, ce, record_pairs: bool = False):
        super().__init__(record_pairs)
        self.ce = ce

    def __call__(self, query, item_idx) -> torch.Tensor:
        self._count(query, item_idx)
        return self.ce.score_pairs(query, item_idx)


class TabulatedScorer(_CountingScorer):
    """Exact-matrix lookup ``score(q, i) = matrix[q, i]``."""

    def __init__(self, matrix, record_pairs: bool = False):
        super().__init__(record_pairs)
        self.matrix = torch.as_tensor(np.asarray(matrix, dtype=np.float32))

    def __call__(self, query, item_idx) -> torch.Tensor:
        self._count(query, item_idx)
        if self.matrix.device != item_idx.device:
            self.matrix = self.matrix.to(item_idx.device)
        return self.matrix[query.long()[:, None], item_idx.long()]
