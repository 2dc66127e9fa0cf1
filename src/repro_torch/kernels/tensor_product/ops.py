"""Public edge tensor-product ops: NequIP's messages (``tensor_product``)
and their gradient (``tensor_product_backward``).  On CUDA tensors they
launch the hand-written kernels (``kernel.py``) or raise; on CPU tensors
they run the plain versions (``ref.py``).  The caller,
``models/gnn/nequip.message_passing``, holds them under its own
``torch.autograd.Function``."""

from __future__ import annotations

from .kernel import tensor_product_backward_cuda, tensor_product_cuda
from .ref import check_tp, tensor_product_backward_plain, tensor_product_plain


def tensor_product(x, w, rhat, y2):
    """(E, 13, h) messages of sender features ``x`` (E, 13, h) under radial
    weights ``w`` (E, 11, h) along ``rhat`` (E, 3) with ``y2`` (E, 3, 3)."""
    if x.is_cuda:
        return tensor_product_cuda(x, w, rhat, y2)
    check_tp(x, w, rhat, y2)
    return tensor_product_plain(x, w, rhat, y2)


def tensor_product_backward(x, w, rhat, y2, g, geometry: bool = False):
    """(dx, dw, drhat, dy2) for the messages' gradient ``g``; drhat and
    dy2 are None unless ``geometry``."""
    if x.is_cuda:
        return tensor_product_backward_cuda(x, w, rhat, y2, g, geometry)
    check_tp(x, w, rhat, y2)
    return tensor_product_backward_plain(x, w, rhat, y2, g, geometry)
