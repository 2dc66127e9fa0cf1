"""Behavior Sequence Transformer  [arXiv:1905.06874] — port of
``repro/models/recsys/bst.py``.

The target item is appended to the user behaviour sequence before the
transformer block, so each (user, item) score is one joint forward pass
over L + 1 positions: a cross-encoder-class scorer, ADACUR's target.

Parameters are a dict in the reference's layout: ``item_emb`` (rows padded
to a multiple of 512, d), ``pos_emb`` (L + 1, d), ``blocks`` a list of
post-LN blocks (``wq``/``wk``/``wv`` (d, H, d/H), ``wo`` (H, d/H, d),
``ffn_w1`` (d, 4d), ``ffn_w2`` (4d, d), ``ln1``/``ln1b``/``ln2``/``ln2b``)
and the head MLP ``mlp{i}_w`` (d_in, d_out) / ``mlp{i}_b`` of widths
d (L + 1) -> ``mlp_dims`` -> 1 (``convert.bst_params`` carries the
reference's across).  Ids index the table as ``jnp.take`` does for ids in
range.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ...configs.base import RecSysConfig
from ...device import resolve_device, to_device
from .. import layers
from .embedding import padded_rows


def init_bst(cfg: RecSysConfig, generator: torch.Generator, device=None) -> Dict:
    """Parameters drawn from ``generator`` on its own device (the port's
    draws, not JAX's bits; the reference's shapes and scales), then moved to
    ``device`` (default ``"cuda"``; without a card it raises unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    d, g = cfg.embed_dim, generator
    params = {
        "item_emb": layers.dense_init(g, (padded_rows(cfg.n_items), d), scale=0.05),
        "pos_emb": layers.dense_init(g, (cfg.seq_len + 1, d), scale=0.05),
    }
    blocks = []
    for _ in range(cfg.n_blocks):
        blk = layers.attention_block_init(g, d, cfg.n_heads)
        blk["ffn_w1"] = layers.dense_init(g, (d, 4 * d))
        blk["ffn_w2"] = layers.dense_init(g, (4 * d, d))
        blk["ln2"] = torch.ones((d,), device=g.device)
        blk["ln2b"] = torch.zeros((d,), device=g.device)
        blocks.append(blk)
    params["blocks"] = blocks
    dims = (d * (cfg.seq_len + 1),) + tuple(cfg.mlp_dims) + (1,)
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"mlp{i}_w"] = layers.dense_init(g, (din, dout))
        params[f"mlp{i}_b"] = torch.zeros((dout,), device=g.device)
    return to_device(params, dev)


def param_specs(cfg: RecSysConfig) -> Dict:
    """The logical axes of every leaf of :func:`init_bst`'s tree (the
    reference's second return value of ``init_bst``)."""
    blk = dict(layers.attention_block_specs(), ffn_w1=("embed", "mlp"),
               ffn_w2=("mlp", "embed"), ln2=("embed",), ln2b=("embed",))
    specs = {"item_emb": ("table_rows", "embed"), "pos_emb": ("seq", "embed"),
             "blocks": [dict(blk) for _ in range(cfg.n_blocks)]}
    for i in range(len(cfg.mlp_dims) + 1):
        specs[f"mlp{i}_w"], specs[f"mlp{i}_b"] = ("mlp_in", "mlp_out"), ("mlp_out",)
    return specs


def _block(blk, x: torch.Tensor) -> torch.Tensor:
    x = layers.post_ln_attention(blk, x)
    h = layers.leaky_relu(x @ blk["ffn_w1"]) @ blk["ffn_w2"]
    return layers.layernorm(x + h, blk["ln2"], blk["ln2b"])


def forward(params, history: torch.Tensor, target: torch.Tensor,
            cfg: RecSysConfig) -> torch.Tensor:
    """history (B, L) item ids, target (B,) item id -> (B,) logit."""
    seq = torch.cat([history, target[:, None].to(history.dtype)], dim=1)   # (B, L+1)
    x = F.embedding(seq, params["item_emb"]) + params["pos_emb"][None]
    for blk in params["blocks"]:
        x = _block(blk, x)
    flat = x.reshape(x.shape[0], -1)
    n_mlp = len(cfg.mlp_dims) + 1
    for i in range(n_mlp):
        flat = flat @ params[f"mlp{i}_w"] + params[f"mlp{i}_b"]
        if i < n_mlp - 1:
            flat = layers.leaky_relu(flat)
    return flat[:, 0]


def bce_loss(params, history, target, labels, cfg: RecSysConfig) -> torch.Tensor:
    """Mean binary cross-entropy of the logits against (B,) labels, in the
    reference's stable form max(x, 0) - x y + log1p(e^-|x|)."""
    logits = forward(params, history, target, cfg)
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


def score_candidates(params, history: torch.Tensor, cand: torch.Tensor,
                     cfg: RecSysConfig) -> torch.Tensor:
    """ADACUR bulk scorer: history (B, L) x cand (B, K) -> (B, K) scores,
    one joint transformer pass per (user, item) pair, like a CE."""
    b, k = cand.shape
    hist_r = torch.repeat_interleave(history, k, dim=0)
    return forward(params, hist_r, cand.reshape(-1), cfg).reshape(b, k)
