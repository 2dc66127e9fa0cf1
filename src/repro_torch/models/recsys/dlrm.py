"""DLRM (MLPerf config): bottom MLP -> embedding lookups -> dot interaction
-> top MLP  [arXiv:1906.00091] — port of ``repro/models/recsys/dlrm.py``.

The (dense-features, sparse-ids) pair is a joint scorer: the dot
interaction mixes query-side and item-side features non-factorizably,
which makes DLRM a cross-encoder-class model for ADACUR.

Parameters are a dict in the reference's layout: ``bot``/``top`` hold
``b{i}_w`` (d_in, d_out) / ``b{i}_b`` and ``t{i}_w`` / ``t{i}_b``,
``tables`` a list of (padded rows, dim) tables (``convert.dlrm_params``
carries the reference's across).
"""

from __future__ import annotations

from typing import Dict

import torch

from ...configs.base import RecSysConfig
from ...device import resolve_device, to_device
from . import embedding


def _mlp_init(generator, dims, prefix, place=None, path="") -> Dict[str, torch.Tensor]:
    place = place or (lambda path, t: t)
    params = {}
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn((din, dout), generator=generator, device=generator.device)
        params[f"{prefix}{i}_w"] = place(f"{path}/{prefix}{i}_w", w.mul_(1.0 / din ** 0.5))
        params[f"{prefix}{i}_b"] = place(f"{path}/{prefix}{i}_b",
                                         torch.zeros((dout,), device=generator.device))
    return params


def _mlp_specs(n_layers: int, prefix: str) -> Dict[str, tuple]:
    specs = {}
    for i in range(n_layers):
        specs[f"{prefix}{i}_w"], specs[f"{prefix}{i}_b"] = ("mlp_in", "mlp_out"), ("mlp_out",)
    return specs


def _mlp_apply(params, prefix, x, n, final_act=False):
    for i in range(n):
        x = x @ params[f"{prefix}{i}_w"] + params[f"{prefix}{i}_b"]
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x


def top_dims(cfg: RecSysConfig) -> tuple:
    """The top MLP's widths: ``top_mlp[0]`` replaced by the dot
    interaction's width n(n-1)/2 + bot_mlp[-1] with n = n_sparse + 1 (479
    for MLPerf)."""
    n_int = cfg.n_sparse + 1
    return (n_int * (n_int - 1) // 2 + cfg.bot_mlp[-1],) + tuple(cfg.top_mlp[1:])


def param_specs(cfg: RecSysConfig) -> Dict:
    """The logical axes of every leaf of :func:`init_dlrm`'s tree (the
    reference's second return value of ``init_dlrm``)."""
    return {"bot": _mlp_specs(len(cfg.bot_mlp) - 1, "b"),
            "top": _mlp_specs(len(top_dims(cfg)) - 1, "t"),
            "tables": embedding.table_specs(len(cfg.table_sizes))}


def init_dlrm(cfg: RecSysConfig, generator: torch.Generator, device=None,
              place=None) -> Dict:
    """Parameters drawn from ``generator`` on its own device, then moved to
    ``device`` (default ``"cuda"``; without a card it raises unless
    ``device="cpu"``).  Draw on the card's generator for the full-size
    tables: tens of GB.  ``place(path, leaf)``, where given, takes each leaf
    as it is drawn (its path as ``tree.leaves_with_paths`` spells it) and
    returns what is kept: over a mesh, the rank's piece, so no rank ever
    holds more than one whole table."""
    dev = resolve_device(device)
    if cfg.kind != "dlrm":
        raise ValueError(f"init_dlrm: {cfg.name} is a {cfg.kind} config, not a dlrm one")
    params = {
        "bot": _mlp_init(generator, cfg.bot_mlp, "b", place, "bot"),
        "top": _mlp_init(generator, top_dims(cfg), "t", place, "top"),
        "tables": embedding.init_tables(generator, cfg.table_sizes, cfg.embed_dim, place),
    }
    return to_device(params, dev)


def forward(params, dense: torch.Tensor, sparse_ids: torch.Tensor,
            cfg: RecSysConfig, lookup=None) -> torch.Tensor:
    """dense (B, 13) float, sparse_ids (B, 26) int -> (B,) logit.
    ``lookup(tables, sparse_ids) -> (B, F, D)`` replaces
    ``embedding.lookup_all_tables`` (over a mesh, the row-sharded one)."""
    bot = _mlp_apply(params["bot"], "b", dense, len(cfg.bot_mlp) - 1, final_act=True)
    emb = (lookup or embedding.lookup_all_tables)(params["tables"], sparse_ids)  # (B, F, D)
    feats = torch.cat([bot[:, None, :], emb], dim=1)                   # (B, F+1, D)
    inter = torch.bmm(feats, feats.transpose(1, 2))                    # (B, F+1, F+1)
    n = feats.shape[1]
    iu, ju = torch.triu_indices(n, n, offset=1, device=feats.device)   # row-major
    flat = inter[:, iu, ju]                                            # (B, n(n-1)/2)
    x = torch.cat([bot, flat], dim=1)
    return _mlp_apply(params["top"], "t", x, len(cfg.top_mlp) - 1)[:, 0]


def bce_loss(params, dense: torch.Tensor, sparse_ids: torch.Tensor, labels: torch.Tensor,
             cfg: RecSysConfig, lookup=None) -> torch.Tensor:
    """Mean binary cross-entropy of the logits against (B,) labels in
    [0, 1], in the reference's stable form max(x, 0) - x y + log1p(e^-|x|).
    Differentiable in every parameter: the lookups go through the bag
    kernel's autograd function."""
    logits = forward(params, dense, sparse_ids, cfg, lookup)
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


def score_candidates(params, dense: torch.Tensor, sparse_ids: torch.Tensor,
                     cand_sparse: torch.Tensor, cfg: RecSysConfig) -> torch.Tensor:
    """ADACUR bulk scorer: one query context vs K candidate items.

    The candidate item occupies sparse field 0 (the 'item id' table in the
    MLPerf layout) of a copy of the context's ids; the context supplies
    dense + the remaining fields.

    dense (B, 13); sparse_ids (B, 26); cand_sparse (B, K) -> (B, K).
    """
    b, k = cand_sparse.shape
    dense_r = torch.repeat_interleave(dense, k, dim=0)
    sparse_r = torch.repeat_interleave(sparse_ids, k, dim=0)      # a copy
    sparse_r[:, 0] = cand_sparse.reshape(-1).to(sparse_r.dtype)
    return forward(params, dense_r, sparse_r, cfg).reshape(b, k)
