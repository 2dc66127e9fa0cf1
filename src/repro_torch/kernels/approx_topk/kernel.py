"""Wrapper of the hand-written CUDA kernel ``csrc/approx_topk.cu`` — the
port of the TPU kernel ``_approx_topk_kernel``
(``repro/kernels/approx_topk/kernel.py:74``).

``approx_topk_cuda`` checks its operands, allocates the outputs and the
per-block scratch, and launches the block kernel and its merge on the
current stream.  ``launches`` counts its calls (one per fused op, i.e. per
block-kernel + merge pair).  The plain PyTorch version of the same function
is ``ops.approx_topk_plain``; ``ops.approx_topk_op`` picks by device.
"""

from __future__ import annotations

import torch

from .. import build
from .quant import QuantizedRanc

ROWS, TCOLS, KMAX = 32, 128, 256   # must match csrc/topk_common.cuh
_TARGET_BLOCKS = 264               # two blocks per SM of an H100 (132 SMs)
_MAX_SUPER = 8192

launches = 0


def super_cols(b: int, n: int) -> int:
    """Columns per block: enough blocks to fill the card, at most 8192
    columns (which keeps the per-block lists a few percent of the payload's
    bytes at N = 10^6).  Results do not depend on it: every score is the
    same fixed-order fp32 sum whatever the tiling."""
    groups = -(-b // ROWS)
    per = -(-n // max(1, -(-_TARGET_BLOCKS // groups)))
    per = -(-per // TCOLS) * TCOLS
    return max(TCOLS, min(_MAX_SUPER, per))


def payload_operands(r_anc):
    """(codes, kind, tile scales, quantization tile) of a payload."""
    if isinstance(r_anc, QuantizedRanc):
        if r_anc.code_dtype != "int8":
            raise ValueError(f"the CUDA kernels take fp32 or int8 payloads, got {r_anc.code_dtype}")
        return r_anc.codes.contiguous(), 1, r_anc.scales.contiguous(), r_anc.tile
    if r_anc.dtype != torch.float32:
        raise ValueError(f"the CUDA kernels take fp32 or int8 payloads, got {r_anc.dtype}")
    return r_anc.contiguous(), 0, None, 1


def check_operands(e_q, codes, k_list, noise, masks, anchors):
    """Device, dtype and shape checks shared by both kernel wrappers."""
    b, k_q = e_q.shape
    n = codes.shape[1]
    if not e_q.is_cuda:
        raise ValueError("the CUDA kernel needs CUDA tensors (the plain "
                         "version serves CPU tensors)")
    if e_q.dtype != torch.float32 or codes.shape[0] != k_q:
        raise ValueError(f"e_q must be (B, k_q) fp32 matching the payload's "
                         f"k_q, got {tuple(e_q.shape)} {e_q.dtype}")
    for t in (codes, noise, anchors, *masks):
        if t is not None and t.device != e_q.device:
            raise ValueError("all operands must be on the same device")
    for k in k_list:
        if not 1 <= k <= min(KMAX, n):
            raise ValueError(f"k={k} outside [1, min({KMAX}, N={n})]")
    if noise is not None and (noise.shape != (b, n) or noise.dtype != torch.float32):
        raise ValueError(f"noise must be ({b}, {n}) fp32")
    for m in masks:
        if m is not None and (m.shape != (b, n) or m.dtype != torch.bool):
            raise ValueError(f"masks must be ({b}, {n}) bool")
    if anchors is not None and (anchors.dim() != 2 or anchors.shape[0] != b):
        raise ValueError(f"anchors must be ({b}, A)")


def as_u8(mask):
    return None if mask is None else mask.contiguous().view(torch.uint8)


def approx_topk_cuda(e_q, r_anc, anchors, k: int, noise=None, mask=None,
                     n_valid=None):
    """(vals (B, k) fp32, idx (B, k) int32) of the fused op, on the card."""
    global launches
    codes, kind, scales, qtile = payload_operands(r_anc)
    check_operands(e_q, codes, [k], noise, [mask], anchors)
    b, k_q = e_q.shape
    n = codes.shape[1]
    n_items = n if n_valid is None else min(int(n_valid), n)
    cols = super_cols(b, n)
    nblk = -(-n // cols)
    dev = e_q.device
    e_q = e_q.contiguous()
    noise = None if noise is None else noise.contiguous()
    anchors = None if anchors is None else anchors.to(torch.int32).contiguous()
    n_anc = 0 if anchors is None else anchors.shape[1]
    blk_v = torch.empty((b, nblk, k), dtype=torch.float32, device=dev)
    blk_i = torch.empty((b, nblk, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    m8 = as_u8(mask)
    # operands and scratch may be freed when this returns, before the kernel
    # ran: the caching allocator hands their memory only to later work on the
    # same stream, which runs after it
    lib = build.load("approx_topk")
    p = build.ptr
    err = lib.approx_topk_launch(
        p(e_q), p(codes), kind, p(scales), qtile, p(noise), p(m8),
        p(anchors), n_anc, b, k_q, n, n_items, k, cols,
        p(blk_v), p(blk_i), p(out_v), p(out_i),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "approx_topk")
    launches += 1
    return out_v, out_i
