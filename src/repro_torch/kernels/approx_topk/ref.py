"""Dense oracle — port of ``repro/kernels/approx_topk/ref.py``: materialize
S_hat, mask, one index-stable top-k over all N columns, for every payload
policy (``quant.matmul``)."""

from __future__ import annotations

import torch

from .ops import anchor_mask
from .quant import QuantizedRanc, matmul, unpacked_codes
from .select import NEG_INF, stable_topk


def dense_scores(e_q, r_anc, anchors=None, noise=None, mask=None, n_valid=None):
    """(B, N) fp32 ``e_q @ R_anc (+ noise)`` with every suppressed entry
    (anchor ids, ``mask``, columns at or past ``n_valid``) at ``NEG_INF``."""
    scores = matmul(e_q, r_anc)
    if noise is not None:
        scores = scores + noise.to(torch.float32)
    b, n = scores.shape
    hit = torch.zeros((b, n), dtype=torch.bool, device=scores.device)
    if anchors is not None:
        hit |= anchor_mask(anchors, b, n, scores.device)
    if mask is not None:
        hit |= mask
    if n_valid is not None:
        hit |= (torch.arange(n, device=scores.device) >= n_valid)[None, :]
    return torch.where(hit, torch.tensor(NEG_INF, device=scores.device), scores)


def approx_topk_reference(e_q, r_anc, anchors, k: int, noise=None, mask=None,
                          n_valid=None):
    return stable_topk(dense_scores(e_q, r_anc, anchors, noise, mask, n_valid), k)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 explicit mantissa bits), ties away
    from zero: ``cvt.rna.tf32.f32`` on the int32 view.  Inf and NaN pass."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    special = (u & 0x7F800000) == 0x7F800000
    r = torch.where(special, u, (u + 0x1000) & 0xFFFFE000)
    r = torch.where(r >= 2**31, r - 2**32, r)
    return r.to(torch.int32).view(torch.float32)


def tf32x3_scores(e_q, r_anc, chunk: int = 32) -> torch.Tensor:
    """(B, N) scores as the CUDA kernels' 3xTF32 mainloop forms them.

    Each fp32 operand splits into ``hi = tf32(x)`` and ``lo = tf32(x - hi)``
    (bf16 values and int8, fp8 and int4 codes are exact: ``lo = 0``); per
    ``chunk`` of k_q the sum of
    a_lo·b_hi + a_hi·b_lo + a_hi·b_hi is formed in float64 (TF32 products
    are exact there) and rounded to fp32 once, and the chunks add in fp32 in
    ascending k_q, as the kernels' ``__fadd_rn`` does.  The tensor core's
    own rounding inside a chunk is not modelled.  A coded payload's scale
    multiplies the finished sum in fp32."""
    a = e_q.to(torch.float32)
    a_hi = tf32_round(a)
    a_lo = tf32_round(a - a_hi)
    if isinstance(r_anc, QuantizedRanc):
        b_hi, b_lo = unpacked_codes(r_anc).to(torch.float32), None
    elif r_anc.dtype == torch.bfloat16:
        b_hi, b_lo = r_anc.to(torch.float32), None
    else:
        b = r_anc.to(torch.float32)
        b_hi = tf32_round(b)
        b_lo = tf32_round(b - b_hi)
    acc = torch.zeros((a.shape[0], b_hi.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, a.shape[1], chunk):
        sl = slice(k0, k0 + chunk)
        part = a_lo[:, sl].double() @ b_hi[sl].double()
        if b_lo is not None:
            part += a_hi[:, sl].double() @ b_lo[sl].double()
        part += a_hi[:, sl].double() @ b_hi[sl].double()
        acc = acc + part.to(torch.float32)
    if isinstance(r_anc, QuantizedRanc):
        acc = acc * r_anc.col_scales()[None, :]
    return acc
