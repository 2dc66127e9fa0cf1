"""Decoder/encoder transformer LM — port of ``repro/models/transformer.py``
on one device: ``padded_vocab``, ``init_lm``, ``_project_qkv``,
``_mlp_block`` (dense and MoE), ``encode`` (train / prefill, optionally
returning every layer's K/V), ``lm_logits``, and the KV-cached decode path
(``init_cache``, ``_local_decode_core``, ``_decode_layer``,
``decode_step``).

Parameters are a dict: ``embed`` (padded vocab, d), ``prefix`` (MoE
configs with ``first_k_dense``: the dense layers that come first) and
``layers`` (lists of per-layer dicts in the reference's layouts: ``attn``
with ``wq``/``wk``/``wv`` (d, heads, hd) and ``wo`` (H, hd, d),
``ln1``/``ln2``, and ``mlp`` or ``moe``), ``final_norm`` and ``lm_head``.
The reference stacks ``layers`` on a leading axis for ``lax.scan``;
``convert.lm_params`` unstacks them.  A KV cache follows the same layout:
``{"layers": [{"k", "v"}, ...], "prefix": [...]}``, each (B, S, KV, hd).
The reference's pluggable ``moe_fn`` / ``decode_core`` (its mesh paths)
are ``encode``'s and ``decode_step``'s keywords; remat and the sharding
constraints wait for training over a mesh (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import LMConfig
from ..kernels.flash_attention.ops import flash_attention
from . import layers, moe as moe_lib


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


def _layer_init(gen: torch.Generator, cfg: LMConfig, use_moe: bool = False):
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
    out = {"attn": attn, "ln1": _norm_init(cfg, d, dev), "ln2": _norm_init(cfg, d, dev)}
    if use_moe:
        out["moe"] = moe_lib.moe_init(gen, d, cfg.moe, dtype=dt)
        return out
    d_ff = cfg.d_ff if cfg.moe is None else (cfg.moe.d_ff_dense or cfg.d_ff)
    out["mlp"] = layers.mlp_init(gen, d, d_ff, cfg.act, dtype=dt)
    if cfg.mlp_bias:
        out["mlp"]["bu"] = torch.zeros(d_ff, dtype=dt, device=dev)
        out["mlp"]["bd"] = torch.zeros(d, dtype=dt, device=dev)
    return out


def n_prefix_layers(cfg: LMConfig) -> int:
    """Dense layers before the homogeneous stack (Moonlight's first dense
    block); 0 for a dense model."""
    return cfg.moe.first_k_dense if cfg.moe is not None else 0


def init_lm(cfg: LMConfig, generator: torch.Generator):
    """Parameters drawn from ``generator`` on its device (the reference's
    shapes, dtypes and scales; the port's own draws)."""
    dt = torch_dtype(cfg)
    n_prefix = n_prefix_layers(cfg)
    params = {"embed": layers.dense_init(generator, (padded_vocab(cfg), cfg.d_model),
                                         scale=0.02, dtype=dt)}
    if n_prefix:
        params["prefix"] = [_layer_init(generator, cfg) for _ in range(n_prefix)]
    params["layers"] = [_layer_init(generator, cfg, cfg.moe is not None)
                        for _ in range(cfg.n_layers - n_prefix)]
    params["final_norm"] = _norm_init(cfg, cfg.d_model, generator.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(
            generator, (cfg.d_model, padded_vocab(cfg)), scale=0.02, dtype=dt)
    return params


def _norm_specs(cfg: LMConfig) -> dict:
    return {"w": ("embed",), "b": ("embed",)} if cfg.norm == "layernorm" else {"w": ("embed",)}


def _layer_specs(cfg: LMConfig, use_moe: bool = False) -> dict:
    attn = {"wq": ("embed", "heads", "head_dim"), "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"), "wo": ("heads", "head_dim", "embed")}
    if cfg.qkv_bias:
        attn.update(bq=("heads", "head_dim"), bk=("kv_heads", "head_dim"),
                    bv=("kv_heads", "head_dim"))
    if cfg.qk_norm:
        attn.update(q_norm=("head_dim",), k_norm=("head_dim",))
    out = {"attn": attn, "ln1": _norm_specs(cfg), "ln2": _norm_specs(cfg)}
    if use_moe:
        out["moe"] = moe_lib.moe_specs(cfg.moe)
        return out
    out["mlp"] = layers.mlp_specs(cfg.act)
    if cfg.mlp_bias:
        out["mlp"].update(bu=("mlp",), bd=("embed",))
    return out


def param_specs(cfg: LMConfig) -> dict:
    """The logical axes of every leaf of :func:`init_lm`'s tree (the
    reference's second return value of ``init_lm``, in the port's layout:
    ``layers`` a list of per-layer trees, each without the reference's
    leading "layers" axis; ``convert.stack_layer_specs`` gives the
    reference's)."""
    n_prefix = n_prefix_layers(cfg)
    specs = {"embed": ("vocab", "embed")}
    if n_prefix:
        specs["prefix"] = [_layer_specs(cfg) for _ in range(n_prefix)]
    specs["layers"] = [_layer_specs(cfg, cfg.moe is not None)
                       for _ in range(cfg.n_layers - n_prefix)]
    specs["final_norm"] = _norm_specs(cfg)
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("embed", "vocab")
    return specs


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


def _mlp_block(cfg: LMConfig, layer_params, x2d, moe_fn=None):
    """FFN of (T, d) tokens -> ((T, d), aux loss): the layer's MoE or dense
    MLP.  ``moe_fn(params, x)`` replaces the single-device MoE (the
    expert-parallel ``moe.make_moe_fn``)."""
    if "moe" in layer_params:
        if moe_fn is not None:
            return moe_fn(layer_params["moe"], x2d)
        return moe_lib.moe_apply_local(layer_params["moe"], x2d, cfg.moe)
    p = layer_params["mlp"]
    zero = torch.zeros((), device=x2d.device)
    if cfg.mlp_bias:
        return F.gelu(x2d @ p["wu"] + p["bu"], approximate="tanh") @ p["wd"] + p["bd"], zero
    return layers.mlp_apply(p, x2d, cfg.act), zero


def _out_proj(o, wo):
    """"...hk,hkd->...d" of attention heads o (..., H, hd)."""
    return o.reshape(*o.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])


def _encode_layer(cfg: LMConfig, attn_fn, h, lp, rope, moe_fn=None):
    b, l, d = h.shape
    x = _apply_norm(cfg, lp["ln1"], h)
    q, k, v = _project_qkv(cfg, lp["attn"], x, rope)
    h = h + _out_proj(attn_fn(q, k, v), lp["attn"]["wo"])
    x2 = _apply_norm(cfg, lp["ln2"], h).reshape(b * l, d)
    ffn, aux = _mlp_block(cfg, lp, x2, moe_fn)
    return h + ffn.reshape(b, l, d), (k, v, aux)


def encode(params, tokens: torch.Tensor, cfg: LMConfig, *, positions=None,
           kv_mask=None, q_chunk: int = 1024, return_kv: bool = False,
           attn_impl: str = "ref", flash_block: Tuple[int, int] = (128, 128),
           flash_interpret: bool = True, moe_fn=None):
    """Full forward pass -> (hidden (B, L, d), aux loss[, kv]).

    The aux loss is the MoE layers' load-balance terms summed (0 for a
    dense model).  With ``return_kv`` the third item is ``(prefix_kv,
    layers_kv)``: lists of each layer's (k, v), (B, L, KV, hd) after RoPE,
    as the reference returns them (its scanned ones stacked).

    ``attn_impl='flash'`` routes attention through ``flash_attention`` (the
    CUDA kernel on the card, its plain version on the CPU); ``kv_mask`` must
    then describe trailing padding only, and is collapsed to per-example
    ``kv_lens = kv_mask.sum(-1)``.  ``flash_block`` shapes only the plain
    version's tiles; ``flash_interpret`` has no effect in the port (kept so
    one kwargs dict drives both packages).  ``moe_fn`` replaces the MoE
    layers' single-device FFN (``_mlp_block``).
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
    aux_total = torch.zeros((), device=h.device)
    kvs = {"prefix": [], "layers": []}
    for part in ("prefix", "layers"):
        for lp in params.get(part, []):
            h, (k, v, aux) = _encode_layer(cfg, attn_fn, h, lp, rope, moe_fn)
            aux_total = aux_total + aux
            if return_kv:
                kvs[part].append((k, v))
    h = _apply_norm(cfg, params["final_norm"], h)
    if return_kv:
        return h, aux_total, (kvs["prefix"], kvs["layers"])
    return h, aux_total


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


# ---------------------------------------------------------------------------
# decode: KV-cached single-token step
# ---------------------------------------------------------------------------


def init_cache(cfg: LMConfig, batch: int, max_len: int, device=None) -> dict:
    """A zero KV cache in the params' layout: ``{"layers": [{"k", "v"}],
    "prefix": [...]}`` (``prefix`` only for a model with dense prefix
    layers), each (batch, max_len, KV, hd) in the model's dtype."""
    dt = torch_dtype(cfg)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    n_prefix = n_prefix_layers(cfg)

    def layer():
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    cache = {"layers": [layer() for _ in range(cfg.n_layers - n_prefix)]}
    if n_prefix:
        cache["prefix"] = [layer() for _ in range(n_prefix)]
    return cache


def _local_decode_core(q, k_new, v_new, ck, cv, pos):
    """Write the new token's K/V at ``pos`` of ck/cv (in place), attend over
    the cache's first ``pos + 1`` entries -> (B, H, hd) in q's dtype."""
    ck.index_copy_(1, pos.reshape(1), k_new[:, None])
    cv.index_copy_(1, pos.reshape(1), v_new[:, None])
    num, den, _ = layers.decode_attention_local(q, ck, cv, shard_offset=0, kv_len=pos + 1)
    return (num / (den[..., None] + 1e-30)).to(q.dtype)


def _decode_layer(cfg: LMConfig, h, lp, c, pos, rope, moe_fn=None,
                  decode_core=_local_decode_core):
    """One decode layer: h (B, d); c the layer's cache {"k", "v"} (B, S,
    KV, hd), written in place.  ``decode_core`` is pluggable: the local
    core above or the sequence-parallel one
    (``distributed.decode_attention.make_decode_core``)."""
    x = _apply_norm(cfg, lp["ln1"], h)
    q, k, v = _project_qkv(cfg, lp["attn"], x[:, None, :], rope)
    o = decode_core(q[:, 0], k[:, 0], v[:, 0], c["k"], c["v"], pos)
    h = h + _out_proj(o, lp["attn"]["wo"])
    ffn, _ = _mlp_block(cfg, lp, _apply_norm(cfg, lp["ln2"], h), moe_fn)
    return h + ffn


def decode_step(params, cache: dict, token: torch.Tensor, pos, cfg: LMConfig, *,
                moe_fn=None, decode_core=None):
    """One autoregressive step: token (B,) int at position ``pos`` (an int or
    a 0-d tensor) -> (logits (B, padded vocab), cache).

    The new K/V are written into ``cache`` IN PLACE at ``pos`` (the
    reference returns an updated copy; a preallocated cache here holds the
    one copy a long context has room for), and the same dict is returned.
    ``pos`` must lie inside the cache (checked when it is an int; a tensor
    is not read back to the host).  ``moe_fn`` and ``decode_core`` are the
    reference's mesh hooks: on a mesh each rank passes its batch rows, its
    chunk of the cache and its experts (``launch.steps.build_lm_decode``
    with ``mesh=``)."""
    dev = token.device
    if decode_core is None:
        decode_core = _local_decode_core
    size = getattr(decode_core, "seq_len",
                   (cache.get("prefix") or cache["layers"])[0]["k"].shape[1])
    if isinstance(pos, int) and not 0 <= pos < size:
        raise ValueError(f"pos={pos} lies outside a cache of {size} entries")
    pos = torch.as_tensor(pos, device=dev).long().reshape(())
    h = F.embedding(token.long(), params["embed"]).to(torch_dtype(cfg))
    rope = layers.rope_tables(pos.reshape(1, 1), cfg.resolved_head_dim, cfg.rope_theta)
    for part in ("prefix", "layers"):
        for lp, c in zip(params.get(part, []), cache.get(part, [])):
            h = _decode_layer(cfg, h, lp, c, pos, rope, moe_fn, decode_core)
    h = _apply_norm(cfg, params["final_norm"], h)
    return lm_logits(params, h, cfg), cache
