"""BERT4Rec  [arXiv:1904.06690]: a bidirectional transformer over the
interaction sequence — port of ``repro/models/recsys/bert4rec.py``.

Two scoring modes:
- ``user_logits``: the standard masked-position prediction (a factorized
  output layer tied to the item table), the cheap retriever;
- ``score_candidates``: candidate-conditioned joint scoring: the candidate
  fills the last slot (as ``cand + 1``: row 0 of the item table is the
  [MASK] embedding) and a head reads a scalar off the mean hidden state,
  one full transformer pass per (user, item) pair.  This is the
  cross-encoder-class re-ranker mode ADACUR accelerates.

Parameters are a dict in the reference's layout: ``item_emb`` (n_items + 1
rows padded to a multiple of 512, d), ``pos_emb`` (L + 1, d), ``blocks`` a
list of post-LN blocks (the attention weights as in ``bst``, ``ffn_w1``
(d, mlp_dims[0]) / ``ffn_b1``, ``ffn_w2`` / ``ffn_b2``, GELU in its tanh
form) and ``score_head`` (d, 1) (``convert.bert4rec_params`` carries the
reference's across).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ...configs.base import RecSysConfig
from ...core import prng
from ...device import resolve_device, to_device
from .. import layers
from .embedding import padded_rows

N_NEG = 512   # mlm_loss's uniform negatives a row


def init_bert4rec(cfg: RecSysConfig, generator: torch.Generator, device=None) -> Dict:
    """Parameters drawn from ``generator`` on its own device (the port's
    draws; the reference's shapes and scales), then moved to ``device``
    (default ``"cuda"``; without a card it raises unless ``device="cpu"``)."""
    dev = resolve_device(device)
    d, g, ff = cfg.embed_dim, generator, cfg.mlp_dims[0]
    params = {
        "item_emb": layers.dense_init(g, (padded_rows(cfg.n_items + 1), d), scale=0.05),
        "pos_emb": layers.dense_init(g, (cfg.seq_len + 1, d), scale=0.05),
    }
    blocks = []
    for _ in range(cfg.n_blocks):
        blk = layers.attention_block_init(g, d, cfg.n_heads)
        blk["ffn_w1"] = layers.dense_init(g, (d, ff))
        blk["ffn_b1"] = torch.zeros((ff,), device=g.device)
        blk["ffn_w2"] = layers.dense_init(g, (ff, d))
        blk["ffn_b2"] = torch.zeros((d,), device=g.device)
        blk["ln2"] = torch.ones((d,), device=g.device)
        blk["ln2b"] = torch.zeros((d,), device=g.device)
        blocks.append(blk)
    params["blocks"] = blocks
    params["score_head"] = layers.dense_init(g, (d, 1), scale=0.02)
    return to_device(params, dev)


def param_specs(cfg: RecSysConfig) -> Dict:
    """The logical axes of every leaf of :func:`init_bert4rec`'s tree (the
    reference's second return value of ``init_bert4rec``)."""
    blk = dict(layers.attention_block_specs(), ffn_w1=("embed", "mlp"), ffn_b1=("mlp",),
               ffn_w2=("mlp", "embed"), ffn_b2=("embed",), ln2=("embed",), ln2b=("embed",))
    return {"item_emb": ("table_rows", "embed"), "pos_emb": ("seq", "embed"),
            "blocks": [dict(blk) for _ in range(cfg.n_blocks)],
            "score_head": ("embed", "unit")}


def _block(blk, x: torch.Tensor) -> torch.Tensor:
    x = layers.post_ln_attention(blk, x)
    h = layers.gelu(x @ blk["ffn_w1"] + blk["ffn_b1"]) @ blk["ffn_w2"] + blk["ffn_b2"]
    return layers.layernorm(x + h, blk["ln2"], blk["ln2b"])


def _encode(params, seq: torch.Tensor) -> torch.Tensor:
    """seq (B, L+1) item ids (0 = [MASK]) -> hidden (B, L+1, d)."""
    x = F.embedding(seq, params["item_emb"]) + params["pos_emb"][None]
    for blk in params["blocks"]:
        x = _block(blk, x)
    return x


def _masked(history: torch.Tensor) -> torch.Tensor:
    return torch.cat([history, torch.zeros_like(history[:, :1])], dim=1)


def user_logits(params, history: torch.Tensor, cfg: RecSysConfig) -> torch.Tensor:
    """Standard BERT4Rec: [MASK] appended, logits = h_mask @ item_emb^T
    over the item rows (the [MASK] row skipped), pad rows at -1e30."""
    h = _encode(params, _masked(history))[:, -1, :]
    logits = h @ params["item_emb"][1:].T
    pad = torch.arange(logits.shape[-1], device=logits.device) >= cfg.n_items
    return logits.masked_fill(pad, layers.NEG_INF)


def score_candidates(params, history: torch.Tensor, cand: torch.Tensor,
                     cfg: RecSysConfig) -> torch.Tensor:
    """Joint mode: the candidate fills the [MASK] slot; a scalar coherence
    score.  history (B, L), cand (B, K) -> (B, K); K full passes a query."""
    b, k = cand.shape
    hist_r = torch.repeat_interleave(history, k, dim=0)               # (B*K, L)
    seq = torch.cat([hist_r, cand.reshape(-1, 1).to(hist_r.dtype) + 1], dim=1)
    pooled = _encode(params, seq).mean(dim=1)
    return (pooled @ params["score_head"])[:, 0].reshape(b, k)


def negatives(batch: int, cfg: RecSysConfig, key=None, device=None,
              n_neg: int = N_NEG) -> torch.Tensor:
    """``mlm_loss``'s uniform negatives, (batch, n_neg) int32 in [0,
    n_items): ``jax.random.randint(key, (batch, n_neg), 0, n_items)`` bit
    for bit, ``key`` defaulting to ``PRNGKey(0)`` as the reference's does.
    A microbatched step slices the whole batch's draw: a draw a microbatch
    would repeat the first rows in each."""
    key = prng.PRNGKey(0) if key is None else key
    return prng.randint(key, (batch, n_neg), 0, cfg.n_items, resolve_device(device))


def mlm_loss(params, history: torch.Tensor, target: torch.Tensor, cfg: RecSysConfig,
             neg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked-item prediction with a sampled softmax over the target and
    ``neg`` (B, M) uniform negatives (default :func:`negatives` of the
    batch): a full softmax over 10^6 items would hold (B, N) logits."""
    b = history.shape[0]
    if neg is None:
        neg = negatives(b, cfg, device=history.device)
    h = _encode(params, _masked(history))[:, -1, :]                   # (B, d)
    e_pos = F.embedding(target + 1, params["item_emb"])
    e_neg = F.embedding(neg + 1, params["item_emb"])
    pos = torch.einsum("bd,bd->b", h, e_pos)
    negs = torch.einsum("bd,bmd->bm", h, e_neg)
    logits = torch.cat([pos[:, None], negs], dim=1)
    return -torch.log_softmax(logits, dim=-1)[:, 0].mean()
