"""ADACUR reference implementation — Algorithm 1 as an executable spec,
port of ``repro/core/adacur.py``.

Buffers grow by concatenation every round, as in the reference; the
production path is the static-shape engine (``core/engine.py``), which
does the same math over preallocated slabs with the fused item-axis
kernels.  Batched: B queries run the round loop together, each with its own
anchor set.  The incremental pinv (default on) extends the previous
pseudo-inverse by the bordering identity; scores are reconstructed as
``e_q @ R_anc`` with ``e_q = C_test @ U``.

Every (B, N) pass here is dense: ``e_q @ R_anc`` and an index-stable top-k
(``select.stable_topk``), on the payload's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..configs.base import AdaCURConfig
from ..kernels.approx_topk.select import NEG_INF, stable_topk
from . import cur, prng, sampling

# score_fn(query pytree, item_idx (B, k)) -> (B, k) exact CE scores
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


def tree_leaves(tree) -> list:
    """The leaves of a query pytree in ``jax.tree_util.tree_leaves`` order:
    dict values by sorted key, list/tuple items in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def query_batch(query, first_anchors=None, batch: Optional[int] = None) -> int:
    """B of a search: ``first_anchors``' rows, else ``batch``, else the first
    leaf's leading dimension (the reference's rule)."""
    if first_anchors is not None:
        return int(first_anchors.shape[0])
    if batch is not None:
        return int(batch)
    return int(tree_leaves(query)[0].shape[0])


def _mark(selected: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return selected.scatter(1, idx.long(), True)


def adacur_search(score_fn: ScoreFn, r_anc: torch.Tensor, query,
                  cfg: AdaCURConfig, key, first_anchors=None,
                  batch: Optional[int] = None,
                  n_valid_items: Optional[int] = None) -> AdaCURResult:
    """Run Algorithm 1 (+ retrieval/re-ranking) for a batch of queries.

    Args:
      score_fn: exact cross-encoder scores for (query, item-id) pairs.
      r_anc: (k_q, N) fp32 anchor-query/all-item score matrix.
      query: batched query pytree (a tensor or a dict of tensors) handed to
        ``score_fn`` untouched.
      cfg: AdaCURConfig (budget, rounds, strategy, split policy).
      key: the port's PRNG key (``prng.PRNGKey``), the reference's bits.
      first_anchors: optional (B, k_s) retriever-chosen first round.
      batch: batch size (``first_anchors``' rows, else this, else the
        first leaf's leading dimension).
      n_valid_items: real item count when R_anc's column axis is padded;
        padded ids are never sampled.
    """
    k_q, n_items = r_anc.shape
    dev = r_anc.device
    k_i = cfg.budget_ce if not cfg.split_budget else cfg.k_anchor
    if k_i % cfg.n_rounds != 0:
        raise ValueError(f"k_i={k_i} not divisible by n_rounds={cfg.n_rounds}")
    k_s = k_i // cfg.n_rounds

    b = query_batch(query, first_anchors, batch)
    if first_anchors is not None and first_anchors.shape[1] != k_s:
        raise ValueError(f"first_anchors must provide k_s={k_s} items, "
                         f"got {tuple(first_anchors.shape)}")

    selected = torch.zeros((b, n_items), dtype=torch.bool, device=dev)
    if n_valid_items is not None and n_valid_items < n_items:
        selected |= (torch.arange(n_items, device=dev) >= n_valid_items)[None, :]
    anchor_idx = c_test = a_buf = p = e_q = None

    keys = prng.split(key, cfg.n_rounds + 1)
    for r in range(cfg.n_rounds):
        # --- SAMPLEANCHORS (Alg. 3) ---------------------------------------
        if r == 0:
            if first_anchors is not None and cfg.first_round == "retriever":
                idx_new = first_anchors.to(device=dev, dtype=torch.int32)
            else:
                idx_new = sampling.sample_random(keys[r], selected, k_s)
        else:
            s_hat = e_q @ r_anc
            n_rand = int(round(cfg.round_epsilon * k_s))
            idx_new = sampling.sample(cfg.strategy, keys[r], s_hat, selected,
                                      k_s - n_rand, cfg.softmax_temp)
            if n_rand:
                # ε-greedy diversity mix (see AdaCURConfig)
                sel_tmp = _mark(selected, idx_new)
                idx_rand = sampling.sample_random(prng.fold_in(keys[r], 1), sel_tmp, n_rand)
                idx_new = torch.cat([idx_new, idx_rand], dim=1)
        selected = _mark(selected, idx_new)

        # --- exact CE scores for the new anchors (Alg. 1 line 15) ----------
        c_new = score_fn(query, idx_new).to(torch.float32)        # (B, k_s)
        cols_new = cur.gather_anchor_columns(r_anc, idx_new)
        if anchor_idx is None:
            anchor_idx, c_test, a_buf = idx_new, c_new, cols_new
        else:
            anchor_idx = torch.cat([anchor_idx, idx_new], dim=1)
            c_test = torch.cat([c_test, c_new], dim=1)
            a_buf = torch.cat([a_buf, cols_new], dim=2)

        # --- APPROXSCORES state update (Alg. 2) -----------------------------
        if cfg.incremental_pinv:
            if p is None:
                p = cur.incremental_pinv_init(a_buf, cfg.pinv_rcond)
            else:
                p = cur.block_pinv_extend(a_buf[..., : r * k_s], p, cols_new)
        else:
            p = cur.pinv(a_buf, cfg.pinv_rcond)                    # (B, rk_s, k_q)
        e_q = torch.einsum("bk,bkq->bq", c_test, p)                # (B, k_q)

    s_hat = e_q @ r_anc                                            # final S_hat

    # --- retrieval ---------------------------------------------------------
    if not cfg.split_budget:
        # ADACUR^No-Split: rank the anchors by their exact CE scores (free)
        top_s, top_pos = stable_topk(c_test, min(cfg.k_retrieve, k_i))
        top_idx = torch.gather(anchor_idx, 1, top_pos.long())
        return AdaCURResult(anchor_idx, c_test, s_hat, top_idx, top_s, k_i, cfg.n_rounds)

    # ADACUR (split): the remaining budget re-ranks the top approximate-
    # scoring non-anchor items; anchors join the final ranking for free
    k_r = cfg.budget_ce - k_i
    _, rerank_idx = stable_topk(torch.where(selected, NEG_INF, s_hat), k_r)
    rerank_scores = score_fn(query, rerank_idx).to(torch.float32)  # k_r CE calls
    pool_idx = torch.cat([anchor_idx, rerank_idx], dim=1)
    pool_scores = torch.cat([c_test, rerank_scores], dim=1)
    top_s, top_pos = stable_topk(pool_scores, min(cfg.k_retrieve, pool_idx.shape[1]))
    top_idx = torch.gather(pool_idx, 1, top_pos.long())
    return AdaCURResult(anchor_idx, c_test, s_hat, top_idx, top_s, cfg.budget_ce,
                        cfg.n_rounds)
