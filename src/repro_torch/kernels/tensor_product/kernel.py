"""Wrapper of the hand-written CUDA kernel ``csrc/tensor_product.cu`` —
NequIP's edge tensor product and its gradient (it replaces no TPU kernel:
the reference's messages are jnp einsums that XLA fuses,
``repro/models/gnn/nequip.py:257``).

``tensor_product_cuda`` checks its operands, allocates the messages and
launches one kernel on the current stream; ``tensor_product_backward_cuda``
allocates dx, dw and (when asked) the geometry's gradients and launches
one kernel.  ``launches`` and ``backward_launches`` count them.  The plain
PyTorch versions are ``ref.tensor_product_plain`` and
``ref.tensor_product_backward_plain``; ``ops`` picks by device.
"""

from __future__ import annotations

import torch

from .. import LaunchCounter, build
from .ref import check_tp

launches = LaunchCounter()
backward_launches = LaunchCounter()


def _operands(*ts):
    if not all(t.is_cuda for t in ts):
        raise ValueError("the CUDA kernel needs CUDA tensors (the plain version serves CPU "
                         "tensors)")
    return [t.contiguous() for t in ts]


def tensor_product_cuda(x, w, rhat, y2) -> torch.Tensor:
    """(E, 13, h) messages on the card."""
    h = check_tp(x, w, rhat, y2)
    x, w, rhat, y2 = _operands(x, w, rhat, y2)
    m = torch.empty_like(x)
    if x.shape[0]:
        err = build.load("tensor_product").tensor_product_launch(
            build.ptr(x), build.ptr(w), build.ptr(rhat), build.ptr(y2), build.ptr(m),
            x.shape[0], h, torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "tensor_product")
        launches.add()
    return m


def tensor_product_backward_cuda(x, w, rhat, y2, g, geometry: bool):
    """(dx, dw, drhat, dy2) on the card; drhat / dy2 (summed over the
    channels, in a fixed order) only when ``geometry``, else None."""
    h = check_tp(x, w, rhat, y2)
    if tuple(g.shape) != tuple(x.shape) or g.dtype != torch.float32:
        raise ValueError(f"g must be float32 {tuple(x.shape)}, got {tuple(g.shape)} {g.dtype}")
    x, w, rhat, y2, g = _operands(x, w, rhat, y2, g)
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    dr = torch.empty_like(rhat) if geometry else None
    dy = torch.empty_like(y2) if geometry else None
    if x.shape[0]:
        err = build.load("tensor_product").tensor_product_backward_launch(
            build.ptr(x), build.ptr(w), build.ptr(rhat), build.ptr(y2), build.ptr(g),
            build.ptr(dx), build.ptr(dw), build.ptr(dr), build.ptr(dy), x.shape[0], h,
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "tensor_product_backward")
        backward_launches.add()
    return dx, dw, dr, dy
