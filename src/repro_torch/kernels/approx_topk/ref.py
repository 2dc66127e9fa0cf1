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


def _rz_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 -> the nearest fp32 toward zero (as float64)."""
    f = x.to(torch.float32)
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f).double()


def tf32x3_scores(e_q, r_anc, chunk: int = 32, truncate: bool = False,
                  carry=None) -> torch.Tensor:
    """(B, N) scores as the CUDA kernels' 3xTF32 mainloop forms them.

    Each fp32 operand splits into ``hi = tf32(x)`` and ``lo = tf32(x - hi)``
    (bf16 values and int8, fp8 and int4 codes are exact: ``lo = 0``).  Per
    ``chunk`` of k_q the products a_lo·b_hi (and a_hi·b_lo) go in first,
    then a_hi·b_hi, 8 of k_q a step, as the kernels' ``mma.sync`` k-steps:

    - ``truncate=False``: the chunk's sum is exact (float64) and rounded to
      fp32 once (no tensor-core rounding);
    - ``truncate=True``: a replay of the tensor core, each step's
      accumulator plus its 8 exact products summed exactly and truncated
      toward zero to fp32 (on an H100 this model reproduces most of the
      kernel's outputs bit for bit, not all: the hardware's exact alignment
      rule is not public).

    The chunks add in fp32 in ascending k_q; with ``carry`` each add's
    rounding error, by Fast2Sum, is where the next chunk's accumulator
    starts.  ``carry=None`` is the kernels' choice: on for the payloads exact
    in TF32, off for fp32.  A coded payload's scale multiplies the finished
    sum in fp32."""
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
    if carry is None:
        carry = b_lo is None
    k_q = a.shape[1]
    acc = torch.zeros((a.shape[0], b_hi.shape[1]), dtype=torch.float32, device=a.device)
    c0 = torch.zeros_like(acc, dtype=torch.float64)
    for k0 in range(0, k_q, chunk):
        steps = []
        for s0 in range(k0, min(k0 + chunk, k_q), 8):
            steps.append((a_lo, b_hi, s0))
            if b_lo is not None:
                steps.append((a_hi, b_lo, s0))
        steps += [(a_hi, b_hi, s0) for s0 in range(k0, min(k0 + chunk, k_q), 8)]
        c = c0.clone()
        for x, y, s0 in steps:
            sl = slice(s0, min(s0 + 8, k_q))
            if truncate:
                prod = x[:, sl].double()[:, None, :] * y[sl].double().T[None, :, :]
                c = _rz_f32(c + prod.sum(-1))
            else:
                c = c + x[:, sl].double() @ y[sl].double()
        c = c.to(torch.float32)
        total = acc + c
        if carry:
            c0 = (c - (total - acc)).double()
        acc = total
    if isinstance(r_anc, QuantizedRanc):
        acc = acc * r_anc.col_scales()[None, :]
    return acc
