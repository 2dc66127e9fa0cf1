"""Transformer building blocks — port of ``repro/models/layers.py``: norms,
RoPE, GQA attention (the plain reference path), MLPs.

Parameters are plain dicts of tensors in the reference's layouts (``wq``
(d, H, hd), ``wo`` (H, hd, d), MLP weights (d_in, d_out)), so carrying
weights across is a rename (``convert.lm_params``).  bf16 is
rounded where the reference rounds: the functions below state where.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def dense_init(generator: torch.Generator, shape, scale=None,
               dtype=torch.float32) -> torch.Tensor:
    """Normal draws times ``scale`` (default 1/sqrt(shape[0]), the
    reference's fan-in rule: for ``wo`` (H, hd, d) that is 1/sqrt(H)).
    The draws are the port's own (a ``torch.Generator``), not JAX's bits."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / fan_in ** 0.5
    x = torch.randn(tuple(shape), generator=generator, device=generator.device)
    return x.to(dtype) * scale


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The reference's rounding points: the sum of squares in fp32, ``inv``
    cast to the activation dtype, then two multiplies in that dtype."""
    xf = x.float()
    var = (xf * xf).sum(-1, keepdim=True) / x.shape[-1]
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * w.to(x.dtype)


def layernorm(x, w, b, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return (x - mu.to(x.dtype)) * inv * w.to(x.dtype) + b.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) fp32 of shape (..., seq, 1, head_dim/2) for positions
    (..., seq): what ``apply_rope`` computes, for reuse across layers."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., :, None, None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The RoPE rotation of x (..., seq, heads, head_dim) in fp32, the
    result cast back to x's dtype."""
    hd = x.shape[-1]
    x1, x2 = x[..., : hd // 2].float(), x[..., hd // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to
    (..., seq).  Angles and the rotation in fp32, the result cast back."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


def repeat_kv(k: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """(B, L, n_kv, hd) -> (B, L, n_kv*q_per_kv, hd) by head repetition."""
    if q_per_kv == 1:
        return k
    return k.repeat_interleave(q_per_kv, dim=2)


def attention_ref(q, k, v, causal: bool, kv_mask: Optional[torch.Tensor] = None,
                  q_chunk: int = 1024) -> torch.Tensor:
    """Exact attention in query chunks (GQA by repeating KV heads).

    q (B, Lq, H, hd), k/v (B, Lk, KV, hd), ``kv_mask`` (B, Lk) per-token
    validity.  Logits and softmax in fp32; the PV product in the activation
    dtype, as the reference does.  The causal mask is the encoder's (query
    i sees keys <= i); decoding attends through
    :func:`decode_attention_local` instead.
    """
    b, lq, n_heads, hd = q.shape
    q_per_kv = n_heads // k.shape[2]
    k = repeat_kv(k, q_per_kv)
    v = repeat_kv(v, q_per_kv)
    scale = 1.0 / hd ** 0.5
    lk = k.shape[1]
    kv_pos = torch.arange(lk, device=q.device)
    kf = k.float()
    outs = []
    for start in range(0, lq, q_chunk):
        qc = q[:, start:start + q_chunk]
        logits = torch.einsum("bchd,blhd->bhcl", qc.float(), kf) * scale
        mask = torch.ones((qc.shape[1], lk), dtype=torch.bool, device=q.device)
        if causal:
            q_pos = start + torch.arange(qc.shape[1], device=q.device)
            mask &= kv_pos[None, :] <= q_pos[:, None]
        mask = mask[None, None]
        if kv_mask is not None:
            mask = mask & kv_mask[:, None, None, :]
        logits = logits.masked_fill(~mask, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhcl,blhd->bchd", probs.to(v.dtype), v))
    return torch.cat(outs, dim=1).to(q.dtype)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 ``bmm`` of two operands of one dtype with fp32 accumulation.  A
    bf16 pair on the card goes through ``out_dtype=torch.float32`` (no fp32
    copy of either operand, no bf16 rounding of the result); on the CPU the
    operands are cast (the CPU holds only the tests' small caches)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def decode_attention_local(q: torch.Tensor, k_shard: torch.Tensor, v_shard: torch.Tensor,
                           shard_offset, kv_len):
    """Partial flash-decode over one KV chunk (the reference's
    ``decode_attention_local``): q (B, H, hd), one new token; k/v (B, Lc,
    KV, hd), cache entries at absolute positions ``shard_offset + j``, of
    which those below ``kv_len`` (an int or a 0-d tensor) are valid.

    Returns (numerator (B, H, hd) fp32, denominator (B, H) fp32, running max
    (B, H) fp32); a combiner merges chunks by the LSE-weighted sum.

    The dots are the cache's dtype times itself with fp32 accumulation and
    fp32 results: the cache is never cast.  An fp32 copy of a bf16 cache
    would double its bytes (on qwen3-8b decode_32k at B = 8 the cache is
    38.6 GB).  The products run one batch row at a time, every KV head's
    query group at once, on strided views of the cache (a batched product
    over (B, KV) would need a reordered copy), each row's fp32 temporaries
    freed before the next.  ``p`` is cast to the cache's dtype for the P V
    product, as the reference casts it.
    """
    b, lc, n_kv, hd = k_shard.shape
    n_heads = q.shape[1]
    g = n_heads // n_kv
    qg = q.reshape(b, n_kv, g, hd)
    invalid = ~(shard_offset + torch.arange(lc, device=q.device) < kv_len)      # (Lc,)
    nums, dens, ms = [], [], []
    for i in range(b):   # one row's (KV, G, Lc) fp32 temporaries live at a time
        logits = _bmm_f32(qg[i], k_shard[i].permute(1, 2, 0)).mul_(1.0 / hd ** 0.5)
        logits.masked_fill_(invalid, NEG_INF)
        m = logits.amax(-1)
        p = logits.sub_(m[..., None]).exp_().masked_fill_(invalid, 0.0)
        nums.append(_bmm_f32(p.to(v_shard.dtype), v_shard[i].transpose(0, 1)))
        dens.append(p.sum(-1))
        ms.append(m)
    return (torch.stack(nums).reshape(b, n_heads, hd), torch.stack(dens).reshape(b, n_heads),
            torch.stack(ms).reshape(b, n_heads))


def mlp_apply(params, x, act: str):
    if act == "swiglu":
        return (F.silu(x @ params["wg"]) * (x @ params["wu"])) @ params["wd"]
    return F.gelu(x @ params["wu"], approximate="tanh") @ params["wd"]


def mlp_init(generator, d_model: int, d_ff: int, act: str, dtype=torch.float32):
    out = {}
    if act == "swiglu":
        out["wg"] = dense_init(generator, (d_model, d_ff), dtype=dtype)
    out["wu"] = dense_init(generator, (d_model, d_ff), dtype=dtype)
    out["wd"] = dense_init(generator, (d_ff, d_model), dtype=dtype)
    return out
