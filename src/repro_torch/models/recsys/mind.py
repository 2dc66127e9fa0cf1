"""MIND: Multi-Interest Network with Dynamic routing  [arXiv:1904.08030] —
port of ``repro/models/recsys/mind.py``.

A capsule (B2I dynamic routing) user encoder makes ``n_interests``
interest vectors; an item's score is max_j <v_j, e_item>.  A dual-encoder:
all-item scores are a few GEMMs, so the model serves as ADACUR's
first-round anchor retriever (the paper's DE_BASE role), not as its CE.

Parameters are a dict in the reference's layout: ``item_emb`` (rows padded
to a multiple of 512, d), ``bilinear`` (d, d), ``b_init`` (n_interests, L)
routing logits and ``proj`` (d, d) (``convert.mind_params``).

``retrieve`` departs from the reference in one place: it scores every row
of the table.  The reference scans ``n_rows // item_tile`` whole tiles
and never scores the rows past the last one (at 10^6 items and tiles of
16,384, items 999,424-999,999).  The port scores the last partial tile
too, so its ids equal an index-stable top-k of :func:`score_all_items`.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ...configs.base import RecSysConfig
from ...device import resolve_device, to_device
from ...kernels.approx_topk.select import topk_value_id
from .. import layers
from .embedding import padded_rows

ITEM_TILE = 16384   # retrieve's item tile, the reference's default


def init_mind(cfg: RecSysConfig, generator: torch.Generator, device=None) -> Dict:
    """Parameters drawn from ``generator`` on its own device (the port's
    draws; the reference's shapes and scales), then moved to ``device``
    (default ``"cuda"``; without a card it raises unless ``device="cpu"``)."""
    dev = resolve_device(device)
    d, g = cfg.embed_dim, generator
    params = {
        "item_emb": layers.dense_init(g, (padded_rows(cfg.n_items), d), scale=0.05),
        "bilinear": layers.dense_init(g, (d, d)),
        "b_init": layers.dense_init(g, (cfg.n_interests, cfg.seq_len), scale=1.0),
        "proj": layers.dense_init(g, (d, d)),
    }
    return to_device(params, dev)


def param_specs(cfg: RecSysConfig) -> Dict:
    """The logical axes of every leaf of :func:`init_mind`'s tree (the
    reference's second return value of ``init_mind``)."""
    return {"item_emb": ("table_rows", "embed"), "bilinear": ("embed", "embed_out"),
            "b_init": ("interest", "seq"), "proj": ("embed", "embed_out")}


def _squash(z: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(z * z, dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * z / torch.sqrt(n2 + 1e-9)


def interest_vectors(params, history: torch.Tensor, cfg: RecSysConfig) -> torch.Tensor:
    """B2I dynamic routing: history (B, L) -> (B, K, d) interest capsules."""
    u = F.embedding(history, params["item_emb"]) @ params["bilinear"]      # (B, L, d)
    b_logit = params["b_init"][None].expand(history.shape[0], -1, -1)    # (B, K, L)
    v = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(b_logit, dim=1)                                  # over capsules
        v = _squash(torch.einsum("bkl,bld->bkd", w, u))
        b_logit = b_logit + torch.einsum("bkd,bld->bkl", v, u)
    return torch.relu(v @ params["proj"]) + v


def _tile_scores(v: torch.Tensor, tile: torch.Tensor) -> torch.Tensor:
    """max over interests of v (B, K, d) . tile (T, d) -> (B, T), one GEMM."""
    b, k, d = v.shape
    return (v.reshape(b * k, d) @ tile.T).reshape(b, k, -1).amax(dim=1)


def score_all_items(params, history: torch.Tensor, cfg: RecSysConfig) -> torch.Tensor:
    """(B, N) retrieval scores: max over interests of dot products, pad rows
    at -1e30.  The products run over the table in ``ITEM_TILE`` rows, the
    products :func:`retrieve` runs, so its ids are an index-stable top-k of
    these scores bit for bit."""
    v = interest_vectors(params, history, cfg)
    table = params["item_emb"]
    scores = torch.cat([_tile_scores(v, table[o:o + ITEM_TILE])
                        for o in range(0, table.shape[0], ITEM_TILE)], dim=1)
    pad = torch.arange(scores.shape[-1], device=scores.device) >= cfg.n_items
    return scores.masked_fill(pad, layers.NEG_INF)


def _sweep(v: torch.Tensor, table: torch.Tensor, k: int, n_items: int, item_tile: int,
           exact: bool):
    """Each tile's top-k candidates, then one index-stable top-k of their
    union -> (values, ids, loose).  A tile's candidates are a
    ``torch.topk`` of its scores (``loose`` flags the rows where that cut a
    tie at the k-th value, so the candidates may miss a lower id), or
    where ``exact`` its index-stable top-k (``topk_value_id``).  The union
    holds every tile's share of the global top-k, so its top-k is the
    global one."""
    vals, ids = [], []
    loose = torch.zeros((v.shape[0],), dtype=torch.bool, device=v.device)
    for off in range(0, table.shape[0], item_tile):
        s = _tile_scores(v, table[off:off + item_tile])
        if off + s.shape[1] > n_items:                                     # hide pad rows
            s[:, max(0, n_items - off):] = layers.NEG_INF
        kk = min(k, s.shape[1])
        if exact:
            gid = torch.arange(off, off + s.shape[1], dtype=torch.int32, device=s.device)
            tv, ti = topk_value_id(s, gid, kk)
        else:
            tv, pos = torch.topk(s, kk, dim=1)
            loose |= (s >= tv[:, -1:]).sum(1) > kk
            ti = pos.to(torch.int32) + off
        vals.append(tv)
        ids.append(ti)
    best_v, best_i = topk_value_id(torch.cat(vals, dim=1), torch.cat(ids, dim=1), k)
    return best_v, best_i, loose


def retrieve(params, history: torch.Tensor, k: int, cfg: RecSysConfig,
             item_tile: int = ITEM_TILE):
    """Tiled retrieval -> (values (B, k) fp32, ids (B, k) int32), best
    first: an index-stable top-k of :func:`score_all_items`.

    The item tiles stream past (``_sweep``), each leaving its k best, so
    no (B, N) score matrix is held.  A tile's top-k is a ``torch.topk``;
    the rows where one cut a tie at its k-th value (rare) are swept again
    with the composite keys (one host sync a call).  Every row is scored,
    the last partial tile included (the module doc)."""
    v = interest_vectors(params, history, cfg)
    table = params["item_emb"]
    item_tile = min(item_tile, table.shape[0])
    k = min(k, item_tile)
    best_v, best_i, loose = _sweep(v, table, k, cfg.n_items, item_tile, exact=False)
    if bool(loose.any()):
        rows = loose.nonzero()[:, 0]
        ev, ei, _ = _sweep(v[rows], table, k, cfg.n_items, item_tile, exact=True)
        best_v, best_i = best_v.index_copy(0, rows, ev), best_i.index_copy(0, rows, ei)
    return best_v, best_i


def sampled_softmax_loss(params, history, target, neg_ids, cfg: RecSysConfig,
                         pow_p: float = 2.0) -> torch.Tensor:
    """Label-aware attention + sampled softmax (the paper's training loss)."""
    v = interest_vectors(params, history, cfg)                           # (B, K, d)
    e_t = F.embedding(target, params["item_emb"])                        # (B, d)
    att = torch.softmax(pow_p * torch.einsum("bkd,bd->bk", v, e_t), dim=-1)
    u = torch.einsum("bk,bkd->bd", att, v)
    e_neg = F.embedding(neg_ids, params["item_emb"])                     # (B, M, d)
    pos = torch.einsum("bd,bd->b", u, e_t)
    neg = torch.einsum("bd,bmd->bm", u, e_neg)
    logits = torch.cat([pos[:, None], neg], dim=1)
    return -torch.log_softmax(logits, dim=-1)[:, 0].mean()
