"""Public flash-attention op — port of ``repro/kernels/flash_attention``'s
``flash_attention`` (``kernel.py:91``), in the reference's layout: q
(B, Lq, H, hd), k/v (B, Lk, KV, hd), output (B, Lq, H, hd) in q's dtype.

On a CUDA tensor it launches the hand-written kernel
(``csrc/flash_attention.cu`` through ``kernel.flash_attention_cuda``), or
raises; on a CPU tensor it runs :func:`flash_attention_plain`, which
repeats the Pallas body (``kernel.py:26-88``) block by block.  The
``block_q``/``block_k`` arguments shape the plain version only: the CUDA
kernel chooses its own tiles (64 query rows, 64 keys).
"""

from __future__ import annotations

import torch

from .kernel import flash_attention_cuda

NEG_INF = -1e30


def flash_attention_plain(q, k, v, *, causal: bool = True, block_q: int = 128,
                          block_k: int = 128, kv_lens=None) -> torch.Tensor:
    """The Pallas kernel's arithmetic in PyTorch: fp32 ``(m, l, acc)``
    online-softmax state over ``block_k`` key tiles, masked logits at
    ``NEG_INF``, ``p`` zeroed where masked, ``acc / (l + 1e-30)`` (so an
    example with ``kv_lens == 0`` gives zeros), right-aligned causal
    ``q_offset = Lk - Lq`` and ``limit = min(Lk, kv_lens[b])``.  Key tiles
    wholly above the causal diagonal are skipped, as the kernel's
    ``pl.when`` skips them."""
    b, lq, h, hd = q.shape
    lk, n_kv = k.shape[1], k.shape[2]
    rep = h // n_kv
    scale = 1.0 / hd ** 0.5
    q_offset = lk - lq
    block_q, block_k = min(block_q, lq), min(block_k, lk)
    dev = q.device
    # (B, H, L, hd) fp32, KV heads repeated onto their query heads
    qh = q.float().permute(0, 2, 1, 3)
    kh = k.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    vh = v.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    limit = torch.full((b,), lk, dtype=torch.int64, device=dev)
    if kv_lens is not None:
        limit = torch.minimum(limit, kv_lens.to(device=dev, dtype=torch.int64))
    limit = limit[:, None, None, None]                         # (B, 1, 1, 1)
    out = torch.empty((b, h, lq, hd), dtype=torch.float32, device=dev)
    for q0 in range(0, lq, block_q):
        qt = qh[:, :, q0:q0 + block_q]
        rows = qt.shape[2]
        m = torch.full((b, h, rows), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, rows), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, rows, hd), dtype=torch.float32, device=dev)
        q_pos = (q_offset + q0 + torch.arange(rows, device=dev))[:, None]
        for k0 in range(0, lk, block_k):
            if causal and k0 > q_offset + q0 + block_q - 1:
                continue
            kt, vt = kh[:, :, k0:k0 + block_k], vh[:, :, k0:k0 + block_k]
            s = torch.matmul(qt, kt.transpose(-1, -2)) * scale  # (B, H, bq, bk)
            kv_pos = k0 + torch.arange(kt.shape[2], device=dev)[None, :]
            mask = kv_pos < limit                                # (B, 1, 1, bk)
            if causal:
                mask = mask & (kv_pos <= q_pos)
            s = s.masked_fill(~mask, NEG_INF)
            m_cur = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_cur)
            p = torch.exp(s - m_cur[..., None]).masked_fill(~mask, 0.0)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.matmul(p, vt)
            m = m_cur
        out[:, :, q0:q0 + rows] = acc / (l[..., None] + 1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128, kv_lens=None) -> torch.Tensor:
    """Blocked online-softmax attention; the backend follows the device."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, kv_lens=kv_lens)
    return flash_attention_plain(q, k, v, causal=causal, block_q=block_q,
                                 block_k=block_k, kv_lens=kv_lens)
