"""Dense transformer encoder — port of the forward path of
``repro/models/transformer.py`` (``padded_vocab``, ``init_lm``,
``_project_qkv``, ``_mlp_block``, ``encode``).

Parameters are a dict: ``embed`` (padded vocab, d), ``layers`` (a list of
per-layer dicts in the reference's layouts: ``attn`` with ``wq``/``wk``/
``wv`` (d, heads, hd) and ``wo`` (H, hd, d), ``ln1``/``ln2``, ``mlp``),
``final_norm`` and ``lm_head``.  The reference stacks the layers on a
leading axis for ``lax.scan``; ``convert.cross_encoder_params`` unstacks
them.  ``lm_logits`` serves the LM train step.  The decode path and its KV
cache, MoE, remat and the sharding constraints are not ported yet
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import LMConfig
from ..kernels.flash_attention.ops import flash_attention
from . import layers


def torch_dtype(cfg: LMConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def padded_vocab(cfg: LMConfig) -> int:
    """Vocab rows padded to a multiple of 512, as the reference pads them."""
    return (cfg.vocab_size + 511) // 512 * 512


def _norm_init(cfg: LMConfig, d: int, device):
    w = {"w": torch.ones(d, device=device)}
    if cfg.norm == "layernorm":
        w["b"] = torch.zeros(d, device=device)
    return w


def _apply_norm(cfg: LMConfig, p, x):
    if cfg.norm == "layernorm":
        return layers.layernorm(x, p["w"], p["b"])
    return layers.rmsnorm(x, p["w"], cfg.rms_eps)


def _layer_init(gen: torch.Generator, cfg: LMConfig):
    hd, d, dt = cfg.resolved_head_dim, cfg.d_model, torch_dtype(cfg)
    dev = gen.device
    attn = {
        "wq": layers.dense_init(gen, (d, cfg.n_heads, hd), dtype=dt),
        "wk": layers.dense_init(gen, (d, cfg.n_kv_heads, hd), dtype=dt),
        "wv": layers.dense_init(gen, (d, cfg.n_kv_heads, hd), dtype=dt),
        "wo": layers.dense_init(gen, (cfg.n_heads, hd, d), dtype=dt),
    }
    if cfg.qkv_bias:
        attn["bq"] = torch.zeros((cfg.n_heads, hd), dtype=dt, device=dev)
        attn["bk"] = torch.zeros((cfg.n_kv_heads, hd), dtype=dt, device=dev)
        attn["bv"] = torch.zeros((cfg.n_kv_heads, hd), dtype=dt, device=dev)
    if cfg.qk_norm:
        attn["q_norm"] = torch.ones(hd, device=dev)
        attn["k_norm"] = torch.ones(hd, device=dev)
    mlp = layers.mlp_init(gen, d, cfg.d_ff, cfg.act, dtype=dt)
    if cfg.mlp_bias:
        mlp["bu"] = torch.zeros(cfg.d_ff, dtype=dt, device=dev)
        mlp["bd"] = torch.zeros(d, dtype=dt, device=dev)
    return {"attn": attn, "ln1": _norm_init(cfg, d, dev), "ln2": _norm_init(cfg, d, dev),
            "mlp": mlp}


def init_lm(cfg: LMConfig, generator: torch.Generator):
    """Parameters drawn from ``generator`` on its device (the reference's
    shapes, dtypes and scales; the port's own draws)."""
    dt = torch_dtype(cfg)
    params = {
        "embed": layers.dense_init(generator, (padded_vocab(cfg), cfg.d_model),
                                   scale=0.02, dtype=dt),
        "layers": [_layer_init(generator, cfg) for _ in range(cfg.n_layers)],
        "final_norm": _norm_init(cfg, cfg.d_model, generator.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(
            generator, (cfg.d_model, padded_vocab(cfg)), scale=0.02, dtype=dt)
    return params


def _project_qkv(cfg: LMConfig, attn, x, rope):
    """q, k, v (..., heads, hd) of x; ``rope`` = ``layers.rope_tables`` of
    the positions (computed once per forward)."""
    def proj(w):          # "...d,dhk->...hk"
        return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])

    q, k, v = proj(attn["wq"]), proj(attn["wk"]), proj(attn["wv"])
    if cfg.qkv_bias:
        q, k, v = q + attn["bq"], k + attn["bk"], v + attn["bv"]
    if cfg.qk_norm:
        q = layers.rmsnorm(q, attn["q_norm"], cfg.rms_eps)
        k = layers.rmsnorm(k, attn["k_norm"], cfg.rms_eps)
    return layers.rotate(q, *rope), layers.rotate(k, *rope), v


def _mlp_block(cfg: LMConfig, layer_params, x2d):
    p = layer_params["mlp"]
    if cfg.mlp_bias:
        return F.gelu(x2d @ p["wu"] + p["bu"], approximate="tanh") @ p["wd"] + p["bd"]
    return layers.mlp_apply(p, x2d, cfg.act)


def _encode_layer(cfg: LMConfig, attn_fn, h, lp, rope):
    b, l, d = h.shape
    x = _apply_norm(cfg, lp["ln1"], h)
    q, k, v = _project_qkv(cfg, lp["attn"], x, rope)
    o = attn_fn(q, k, v)
    wo = lp["attn"]["wo"]                 # "...hk,hkd->...d"
    h = h + (o.reshape(b, l, -1) @ wo.reshape(-1, wo.shape[-1]))
    x2 = _apply_norm(cfg, lp["ln2"], h).reshape(b * l, d)
    return h + _mlp_block(cfg, lp, x2).reshape(b, l, d)


def encode(params, tokens: torch.Tensor, cfg: LMConfig, *, positions=None,
           kv_mask=None, q_chunk: int = 1024, attn_impl: str = "ref",
           flash_block: Tuple[int, int] = (128, 128), flash_interpret: bool = True):
    """Full forward pass -> (hidden (B, L, d), aux loss 0).

    ``attn_impl='flash'`` routes attention through ``flash_attention`` (the
    CUDA kernel on the card, its plain version on the CPU); ``kv_mask`` must
    then describe trailing padding only, and is collapsed to per-example
    ``kv_lens = kv_mask.sum(-1)``.  ``flash_block`` shapes only the plain
    version's tiles; ``flash_interpret`` has no effect in the port (kept so
    one kwargs dict drives both packages).
    """
    b, l = tokens.shape
    if positions is None:
        positions = torch.arange(l, device=tokens.device)[None, :].expand(b, l)
    # F.embedding: the same rows as indexing, and a deterministic backward on
    # the card (a sort, not atomics), which training's bitwise resume needs
    h = F.embedding(tokens.long(), params["embed"]).to(torch_dtype(cfg))

    if attn_impl == "flash":
        kv_lens = None if kv_mask is None else kv_mask.sum(-1).to(torch.int32)

        def attn_fn(q, k, v):
            return flash_attention(q, k, v, causal=cfg.causal, block_q=flash_block[0],
                                   block_k=flash_block[1], kv_lens=kv_lens)
    elif attn_impl == "ref":
        def attn_fn(q, k, v):
            return layers.attention_ref(q, k, v, causal=cfg.causal, q_chunk=q_chunk,
                                        kv_mask=kv_mask)
    else:
        raise ValueError(f"unknown attn_impl '{attn_impl}' (ref|flash)")

    rope = layers.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    for lp in params["layers"]:
        h = _encode_layer(cfg, attn_fn, h, lp, rope)
    h = _apply_norm(cfg, params["final_norm"], h)
    return h, torch.zeros((), device=h.device)


def lm_logits(params, hidden: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """(..., padded vocab) logits of hidden states (..., d): the tied
    embedding's transpose or ``lm_head``; the padded vocab rows are set to
    -1e30, as the reference masks them."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = hidden @ head
    pv = padded_vocab(cfg)
    if pv != cfg.vocab_size:
        mask = torch.arange(pv, device=logits.device) < cfg.vocab_size
        logits = torch.where(mask, logits, torch.tensor(-1e30, dtype=logits.dtype,
                                                        device=logits.device))
    return logits
