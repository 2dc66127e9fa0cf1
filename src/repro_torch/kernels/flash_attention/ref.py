"""Dense oracle for the flash-attention kernel — port of
``repro/kernels/flash_attention/ref.py::attention_reference`` — and
``flash_split_p_emulated``, the bf16 CUDA kernel's arithmetic in PyTorch,
which the CPU tests hold to the Pallas kernel."""

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


def flash_split_p_emulated(q, k, v, *, causal: bool = True, kv_lens=None,
                           block_k: int = 64, terms: int = 3) -> torch.Tensor:
    """The bf16 tensor-core kernel's arithmetic (``csrc/flash_attention.cu``,
    ``flash_tc_kernel``) in PyTorch: bf16 q, k, v; fp32 logits; an online
    softmax over ``block_k``-key tiles in the log2 domain (running max of
    the raw logits, ``p = exp2(s * scale * log2e - m * scale * log2e)``,
    masked p zeroed, ``l`` summing the fp32 p); each tile's P V from p split
    into ``terms`` bf16 terms (the kernel's 3), each the truncation to bf16
    of what the earlier ones leave (``terms=1``: p truncated to one bf16),
    accumulated in fp32 and added to ``O * alpha``; ``O / (l + 1e-30)``
    rounded to bf16.  What it does not repeat: the tensor core's truncated
    sums and its order of addition."""
    b, lq, h, hd = q.shape
    lk, n_kv = k.shape[1], k.shape[2]
    rep = h // n_kv
    sl2 = (1.0 / hd ** 0.5) * 1.4426950408889634
    dev = q.device
    qh = q.to(torch.bfloat16).float().permute(0, 2, 1, 3)                # (B, H, Lq, hd)
    kh = k.to(torch.bfloat16).float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    vh = v.to(torch.bfloat16).float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    limit = torch.full((b,), lk, dtype=torch.int64, device=dev)
    if kv_lens is not None:
        limit = torch.minimum(limit, kv_lens.to(device=dev, dtype=torch.int64))
    limit = limit[:, None, None, None]
    q_pos = (lk - lq + torch.arange(lq, device=dev))[:, None]
    m = torch.full((b, h, lq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=dev)
    o = torch.zeros((b, h, lq, hd), dtype=torch.float32, device=dev)
    for k0 in range(0, lk, block_k):
        s = torch.matmul(qh, kh[:, :, k0:k0 + block_k].transpose(-1, -2))   # raw logits
        kv_pos = k0 + torch.arange(s.shape[-1], device=dev)[None, :]
        mask = kv_pos < limit
        if causal:
            mask = mask & (kv_pos <= q_pos)
        s = s.masked_fill(~mask, NEG_INF)
        m_cur = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_cur) * sl2)
        p = torch.exp2(s * sl2 - (m_cur * sl2)[..., None]).masked_fill_(~mask, 0.0)
        l = l * alpha + p.sum(-1)
        vt = vh[:, :, k0:k0 + block_k]
        parts = []
        for _ in range(terms):
            parts.append((p.view(torch.int32) & -65536).view(torch.float32))   # top 16 bits
            p = p - parts[-1]
        pv = torch.zeros_like(o)
        for part in reversed(parts):                  # smallest terms first
            pv = pv + torch.matmul(part, vt)
        o = o * alpha[..., None] + pv
        m = m_cur
    return (o / (l[..., None] + 1e-30)).permute(0, 2, 1, 3).to(torch.bfloat16)
