"""Wrapper of the hand-written CUDA kernel ``csrc/flash_attention.cu`` —
the port of the TPU kernel ``_flash_kernel``
(``repro/kernels/flash_attention/kernel.py:26``).

``flash_attention_cuda`` checks its operands, allocates the output and
launches one kernel on the current stream, by dtype: bf16 operands go to
the tensor-core kernel (wgmma; P in three bf16 terms; K/V tiles by TMA),
fp32 ones to the exact fp32 CUDA-core kernel.  q, k and v are read in the
(B, L, heads, hd) layout through their strides, so no transposed copy is
made; an operand whose last stride is not 1, or (bf16) whose base or
other strides are not positive multiples of 16 bytes (what a TMA tensor
map takes), is copied to a contiguous tensor first.  ``launches`` counts
its launches.  The plain PyTorch version is ``ops.flash_attention_plain``;
``ops.flash_attention`` picks by device.
"""

from __future__ import annotations

import ctypes

import torch

from .. import LaunchCounter, build, refuse_autograd

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter()


def _readable(t) -> bool:
    """The kernel reads ``t`` in place: unit last stride and, for bf16 (read
    by TMA), a 16-byte aligned base and positive (batch, sequence, head)
    strides that are multiples of 16 bytes."""
    if t.stride(-1) != 1:
        return False
    if t.dtype != torch.bfloat16:
        return True
    return t.data_ptr() % 16 == 0 and all(s > 0 and s % 8 == 0 for s in t.stride()[:3])


def flash_attention_cuda(q, k, v, *, causal: bool = True, kv_lens=None) -> torch.Tensor:
    """(B, Lq, H, hd) attention output in q's dtype, on the card."""
    if not q.is_cuda:
        raise ValueError("the CUDA kernel needs CUDA tensors (the plain version "
                         "serves CPU tensors)")
    refuse_autograd("flash_attention", q, k, v)
    b, lq, h, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k and v must be (B, Lk, KV, hd) matching q {tuple(q.shape)}, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    lk, n_kv = k.shape[1], k.shape[2]
    if n_kv == 0 or h % n_kv:
        raise ValueError(f"{h} query heads do not fold onto {n_kv} KV heads")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes float32 or bfloat16 q, k, v of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    for t in (k, v, kv_lens):
        if t is not None and t.device != q.device:
            raise ValueError("all operands must be on the same device")
    q, k, v = (t if _readable(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    if kv_lens is not None:
        if kv_lens.shape != (b,):
            raise ValueError(f"kv_lens must be ({b},), got {tuple(kv_lens.shape)}")
        kv_lens = kv_lens.to(torch.int32).contiguous()
    out = torch.empty((b, lq, h, hd), dtype=q.dtype, device=q.device)
    lib = build.load("flash_attention")
    p = build.ptr
    err = lib.flash_attention_launch(
        p(q), p(k), p(v), p(out), p(kv_lens), DTYPES[q.dtype],
        b, lq, lk, h, n_kv, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), ctypes.c_float(1.0 / hd ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_attention")
    launches.add()
    return out
