"""Cross-encoder scorer f(q, i) = head(T(concat(q, [SEP], i))) — port of
``repro/models/cross_encoder.py``.

The CE reads the joint query-item sequence bidirectionally and takes a
scalar score off the [CLS] position.  Any LM backbone of the registry can
serve, MoE ones included: ``encode`` runs their MoE layers on one device
(the reference's ``moe_fn=None``), and the load-balance loss is dropped.
A causal config (the registry's LMs as they are) lets position 0 see only
``[CLS]``, so every pair gets the same score: serve a backbone as a CE with
``causal=False``, as ``launch/steps.py::build_lm_adacur_serve``'s callers
do.
"""

from __future__ import annotations

import torch

from ..configs.base import LMConfig
from ..device import resolve_device, to_device
from . import layers, transformer


def init_cross_encoder(cfg: LMConfig, generator: torch.Generator, device=None):
    """Parameters drawn from ``generator`` on its own device, then moved to
    ``device`` (default ``"cuda"``), so one seed gives the same weights on
    every device."""
    dev = resolve_device(device)
    params = transformer.init_lm(cfg, generator)
    params["score_head"] = layers.dense_init(generator, (cfg.d_model, 1), scale=0.02)
    return to_device(params, dev)


def score_tokens(params, pair_tokens: torch.Tensor, cfg: LMConfig, pad_id: int = 0,
                 attn_impl: str = "ref", flash_block=(128, 128),
                 flash_interpret: bool = True) -> torch.Tensor:
    """Exact CE scores (B,) fp32 of (B, L) pair tokens, valid tokens first
    with trailing ``pad_id`` padding (so the flash path masks per-example
    lengths)."""
    kv_mask = pair_tokens != pad_id
    h, _ = transformer.encode(params, pair_tokens, cfg, kv_mask=kv_mask,
                              attn_impl=attn_impl, flash_block=flash_block,
                              flash_interpret=flash_interpret)
    cls = h[:, 0, :].float()
    return (cls @ params["score_head"].float())[:, 0]


def build_pair_tokens(query_tokens: torch.Tensor, item_tokens: torch.Tensor, *,
                      pad_to: int, cls_id: int = 1, sep_id: int = 2,
                      pad_id: int = 0) -> torch.Tensor:
    """``[CLS] q [SEP] i [SEP]`` + padding: query_tokens (B, Lq), item_tokens
    (B, K, Li) -> (B, K, pad_to) int32."""
    b, lq = query_tokens.shape
    _, k, li = item_tokens.shape
    length = lq + li + 3
    if pad_to < length:
        raise ValueError(f"pad_to={pad_to} cannot hold a pair of length {length}")
    dev = item_tokens.device

    def fill(tok, n):
        return torch.full((b, k, n), tok, dtype=torch.int32, device=dev)

    q = query_tokens[:, None, :].expand(b, k, lq).to(torch.int32)
    return torch.cat([fill(cls_id, 1), q, fill(sep_id, 1), item_tokens.to(torch.int32),
                      fill(sep_id, 1), fill(pad_id, pad_to - length)], dim=-1)


def score_pairs(params, pair_tokens: torch.Tensor, cfg: LMConfig, pad_id: int = 0,
                attn_impl: str = "ref", flash_block=(128, 128),
                flash_interpret: bool = True) -> torch.Tensor:
    """(B, K) scores of (B, K, L) pair tokens: the item axis is flattened
    into the CE batch."""
    b, k, l = pair_tokens.shape
    flat = score_tokens(params, pair_tokens.reshape(b * k, l), cfg, pad_id,
                        attn_impl=attn_impl, flash_block=flash_block,
                        flash_interpret=flash_interpret)
    return flat.reshape(b, k)


def ranking_loss(params, pair_tokens: torch.Tensor, cfg: LMConfig,
                 pad_id: int = 0) -> torch.Tensor:
    """In-batch softmax ranking loss of (B, K, L) pair tokens whose item 0 is
    the gold item.  Differentiable: it scores through the ``ref`` attention
    path, as the reference does (the flash kernel has no backward)."""
    scores = score_pairs(params, pair_tokens, cfg, pad_id)        # (B, K)
    return -torch.log_softmax(scores, dim=-1)[:, 0].mean()
