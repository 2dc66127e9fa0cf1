"""Wrapper of the hand-written CUDA kernel ``csrc/approx_topk.cu`` — the
port of the TPU kernel ``_approx_topk_kernel``
(``repro/kernels/approx_topk/kernel.py:74``).

``approx_topk_cuda`` checks its operands, allocates the outputs and the
per-block scratch, and launches the sweep kernel and its merge on the
current stream.  It takes every payload policy: fp32 and bf16 tensors and
int8, fp8 e4m3 and packed int4 codes (:func:`payload_operands`), each
decoded in the kernel's registers, for any k up to 1024 (``KMAX_LARGE``).
``launches`` counts its calls (one per fused op, i.e. per sweep + merge
pair); :func:`plan_grid` sizes the grid.  The plain PyTorch
version of the same function is ``ops.approx_topk_plain``;
``ops.approx_topk_op`` picks by device.
"""

from __future__ import annotations

import torch

from .. import LaunchCounter, build, refuse_autograd
from . import quant
from .quant import QuantizedRanc

# must match csrc/topk_common.cuh: KMAX is the longest list of the
# persistent round's kernel and of approx_topk's k <= 256 sweep, KMAX_LARGE
# approx_topk's longest (its large-k sweep, k in (256, 1024])
ROWS, TCOLS, BK, KMAX, KMAX_LARGE = 32, 512, 32, 256, 1024
H100_SMS = 132

launches = LaunchCounter()


def plan_grid(b: int, n: int, sms: int = H100_SMS) -> tuple[int, int]:
    """(column ranges, columns per range) of the sweep's grid.

    Blocks are (32-row group, column range), one per SM (their 255
    registers a thread allow no second), so the grid is one wave: each row
    group gets ``sms // groups`` ranges of whole TCOLS-column tiles.  Row
    groups vary fastest, so the blocks of one range run together and read
    the payload from HBM about once.  Results do not depend on the plan: every score is
    the same chunked sum whatever the tiling, and selection is exact."""
    groups = -(-b // ROWS)
    tiles = -(-n // TCOLS)
    ranges = max(1, min(sms // groups, tiles))
    cols = -(-tiles // ranges) * TCOLS
    return -(-n // cols), cols


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 by round to nearest, ties away (the kernels' rounding)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def fragment_split(e_q: torch.Tensor):
    """e_q (B, k_q) -> its TF32 hi and lo parts in the kernels' A-fragment
    order, each (row groups, k_q chunks, BK/8, 2, 32, 4) fp32.

    Rows pad to a multiple of 32 and k_q to a multiple of BK with zeros.
    Entry [grp, chunk, ks, mi, lane, j] is row grp*32 + mi*16 + (lane >> 2)
    + 8*(j & 1), column chunk*BK + ks*8 + (lane & 3) + 4*(j >> 1): the four
    values of an mma.m16n8k8 A fragment, so a warp reads one with a 16-byte
    load.  The split is the same for every launch on these rows, so both
    kernels see the same operands."""
    b, k_q = e_q.shape
    groups, chunks = -(-b // ROWS), -(-k_q // BK)
    x = torch.zeros((groups * ROWS, chunks * BK), dtype=torch.float32, device=e_q.device)
    x[:b, :k_q] = e_q
    hi = _tf32(x)
    lo = _tf32(x - hi)

    def frag(t):   # rows (grp, mi, jr, g), columns (chunk, ks, jk, t)
        t = t.view(groups, 2, 2, 8, chunks, BK // 8, 2, 4)
        t = t.permute(0, 4, 5, 1, 3, 7, 6, 2).contiguous()
        return t.view(groups, chunks, BK // 8, 2, 32, 4)

    return frag(hi), frag(lo)


def sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


# the kernels' PayloadKind (csrc/topk_common.cuh) of each payload policy,
# and the storage dtype its operand must have
PAYLOAD_KINDS = {"float32": (0, torch.float32), "int8": (1, torch.int8),
                 "bfloat16": (2, torch.bfloat16), "fp8": (3, torch.float8_e4m3fn),
                 "int4": (4, torch.uint8)}


def payload_operands(r_anc):
    """(storage, kind, tile scales, quantization tile, logical N) of a
    payload: fp32 or bf16 (k_q, N) tensors, int8 / fp8 (k_q, N) codes or
    packed int4 (k_q, ceil(N / 2)) bytes with their per-tile scales.
    Anything else raises."""
    name = quant.payload_dtype_of(r_anc)
    kind, dtype = PAYLOAD_KINDS.get(name, (None, None))
    coded = isinstance(r_anc, QuantizedRanc)
    storage = r_anc.codes if coded else r_anc
    if kind is None or storage.dtype != dtype or coded != (name in quant.CODE_DTYPES):
        raise ValueError(f"the CUDA kernels take {tuple(PAYLOAD_KINDS)} payloads, got "
                         f"{name} stored as {storage.dtype}")
    if coded:
        return storage.contiguous(), kind, r_anc.scales.contiguous(), r_anc.tile, r_anc.shape[1]
    return storage.contiguous(), kind, None, 1, r_anc.shape[1]


def check_operands(e_q, codes, n, k_list, noise, masks, anchors, kmax: int = KMAX,
                   name: str = "approx_topk"):
    """Device, dtype, shape and autograd checks shared by both kernel
    wrappers (``name``); ``n`` is the payload's logical item count, ``kmax``
    the wrapper's longest list."""
    b, k_q = e_q.shape
    if not e_q.is_cuda:
        raise ValueError("the CUDA kernel needs CUDA tensors (the plain "
                         "version serves CPU tensors)")
    refuse_autograd(name, e_q, codes, noise)
    if e_q.dtype != torch.float32 or codes.shape[0] != k_q:
        raise ValueError(f"e_q must be (B, k_q) fp32 matching the payload's "
                         f"k_q, got {tuple(e_q.shape)} {e_q.dtype}")
    for t in (codes, noise, anchors, *masks):
        if t is not None and t.device != e_q.device:
            raise ValueError("all operands must be on the same device")
    for k in k_list:
        if not 1 <= k <= min(kmax, n):
            raise ValueError(f"k={k} outside [1, min({kmax}, N={n})]")
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
    """(vals (B, k) fp32, idx (B, k) int32) of the fused op, on the card,
    for 1 <= k <= min(1024, N): k <= 256 launches the serving path's sweep,
    a larger k its large-k instantiation (lists merged 256 entries at a
    time)."""
    codes, kind, scales, qtile, n = payload_operands(r_anc)
    check_operands(e_q, codes, n, [k], noise, [mask], anchors, kmax=KMAX_LARGE)
    b, k_q = e_q.shape
    n_items = n if n_valid is None else min(int(n_valid), n)
    dev = e_q.device
    nblk, cols = plan_grid(b, n, sm_count(dev))
    a_hi, a_lo = fragment_split(e_q)
    noise = None if noise is None else noise.contiguous()
    anchors = None if anchors is None else anchors.to(torch.int32).contiguous()
    n_anc = 0 if anchors is None else anchors.shape[1]
    blk_v = torch.empty((b, nblk, k), dtype=torch.float32, device=dev)
    blk_i = torch.empty((b, nblk, k), dtype=torch.int32, device=dev)
    gthr = torch.empty((b,), dtype=torch.int32, device=dev)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    m8 = as_u8(mask)
    # operands and scratch may be freed when this returns, before the kernel
    # ran: the caching allocator hands their memory only to later work on the
    # same stream, which runs after it
    p = build.ptr
    launch = (build.load(build.topk_library("approx_topk", kind)).approx_topk_launch
              if k <= KMAX else
              build.load(build.topk_library("approx_topk_large", kind)).approx_topk_large_launch)
    err = launch(
        p(a_hi), p(a_lo), p(codes), kind, p(scales), qtile, p(noise), p(m8),
        p(anchors), n_anc, b, k_q, n, n_items, k, cols,
        p(blk_v), p(blk_i), p(gthr), p(out_v), p(out_i),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "approx_topk")
    launches.add()
    return out_v, out_i
