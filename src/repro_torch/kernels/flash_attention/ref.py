"""Dense oracle for the flash-attention kernel — port of
``repro/kernels/flash_attention/ref.py::attention_reference``."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_reference(q, k, v, causal: bool = True) -> torch.Tensor:
    """q (B, Lq, H, hd), k/v (B, Lk, KV, hd) -> (B, Lq, H, hd) in q's dtype;
    fp32 logits, softmax and PV product; right-aligned causal mask."""
    b, lq, h, hd = q.shape
    lk, n_kv = k.shape[1], k.shape[2]
    rep = h // n_kv
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / hd ** 0.5
    if causal:
        mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device).tril(lk - lq)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
