"""Result type and scorer signature of the ADACUR search — port of the
parts of ``repro/core/adacur.py`` the engine uses.  (The Algorithm-1
reference ``adacur_search`` is not ported yet.)"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

# score_fn(query_ids (B,), item_idx (B, k)) -> (B, k) exact CE scores
ScoreFn = Callable[..., torch.Tensor]


@dataclass
class AdaCURResult:
    """Everything Algorithm 1 returns, plus the final retrieval."""

    anchor_idx: torch.Tensor              # (B, k_i) anchor ids, sampling order
    anchor_scores: torch.Tensor           # (B, k_i) their exact CE scores
    approx_scores: Optional[torch.Tensor]  # (B, N) S_hat, or None
    topk_idx: torch.Tensor                # (B, k) retrieved ids
    topk_scores: torch.Tensor             # (B, k) their exact CE scores
    ce_calls: int                         # planned CE calls per query
    rounds_done: Optional[int] = None     # rounds executed
