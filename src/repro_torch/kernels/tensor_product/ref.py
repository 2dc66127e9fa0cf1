"""Plain PyTorch version of the edge tensor product
(``csrc/tensor_product.cu``): NequIP's messages of one interaction block,
the reference's ``messages`` (``repro/models/gnn/nequip.py:257``) in the
port's component-major layout.

Layout (fp32): ``x`` (E, 13, h) the sender's features — s, then v_0..2,
then t_ij at 4 + 3i + j; ``w`` (E, 11, h) the radial weights in
``PATHS`` order; ``rhat`` (E, 3); ``y2`` (E, 3, 3).  The messages come
back in ``x``'s layout.  The reference keeps s (E, h), v (E, h, 3) and
t (E, h, 3, 3) apart; the same numbers, transposed.

``tensor_product_backward_plain`` is the gradient by autograd of the plain
version, the CPU backend of ``ops.tensor_product_backward``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# tensor-product paths computed in each interaction block (the reference's _PATHS)
PATHS = (
    "ss", "vv_s",            # -> scalars
    "sv", "vs", "vv_v", "tv_v", "vt_v",   # -> vectors
    "st", "vv_t", "ts", "tt_t",           # -> tensors
)
IRREP_ROWS = 13          # 1 + 3 + 9: s, v, t of one channel


def sym_traceless(m: torch.Tensor) -> torch.Tensor:
    """The reference's ``_sym_traceless`` over dims (1, 2) of (E, 3, 3, ...)."""
    m = 0.5 * (m + m.transpose(1, 2))
    tr = m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    eye = eye.reshape((1, 3, 3) + (1,) * (m.dim() - 3))
    return m - tr[:, None, None] * eye / 3.0


def check_tp(x: torch.Tensor, w: torch.Tensor, rhat: torch.Tensor, y2: torch.Tensor) -> int:
    """Raise on what neither version takes; returns h."""
    if x.dim() != 3 or x.shape[1] != IRREP_ROWS:
        raise ValueError(f"x must be (E, {IRREP_ROWS}, h), got {tuple(x.shape)}")
    e, _, h = x.shape
    if tuple(w.shape) != (e, len(PATHS), h):
        raise ValueError(f"w must be (E, {len(PATHS)}, h) = {(e, len(PATHS), h)}, "
                         f"got {tuple(w.shape)}")
    if tuple(rhat.shape) != (e, 3) or tuple(y2.shape) != (e, 3, 3):
        raise ValueError(f"rhat (E, 3) and y2 (E, 3, 3), got {tuple(rhat.shape)} and "
                         f"{tuple(y2.shape)}")
    if any(t.dtype != torch.float32 for t in (x, w, rhat, y2)):
        raise ValueError("the tensor product takes float32 operands")
    if len({t.device for t in (x, w, rhat, y2)}) != 1:
        raise ValueError("the tensor product's operands must share one device")
    return h


def tensor_product_plain(x: torch.Tensor, w: torch.Tensor, rhat: torch.Tensor,
                         y2: torch.Tensor) -> torch.Tensor:
    """(E, 13, h) messages; any device, differentiable."""
    e, _, h = x.shape
    wp = {name: w[:, i] for i, name in enumerate(PATHS)}
    se, ve, te = x[:, 0], x[:, 1:4], x[:, 4:].reshape(e, 3, 3, h)
    r = rhat[:, :, None]                                         # (E, 3, 1)
    m_s = wp["ss"] * se + wp["vv_s"] * (ve * r).sum(1)
    m_v = wp["sv"][:, None] * (se[:, None] * r)
    m_v = m_v + wp["vs"][:, None] * ve
    m_v = m_v + wp["vv_v"][:, None] * torch.linalg.cross(ve, r.expand_as(ve), dim=1)
    m_v = m_v + wp["tv_v"][:, None] * torch.einsum("eijh,ej->eih", te, rhat)
    m_v = m_v + wp["vt_v"][:, None] * torch.einsum("eij,ejh->eih", y2, ve)
    m_t = wp["st"][:, None, None] * (se[:, None, None] * y2[..., None])
    m_t = m_t + wp["ts"][:, None, None] * te
    m_t = m_t + wp["vv_t"][:, None, None] * sym_traceless(ve[:, :, None] * rhat[:, None, :, None])
    m_t = m_t + wp["tt_t"][:, None, None] * sym_traceless(torch.einsum("eijh,ejk->eikh", te, y2))
    return torch.cat([m_s[:, None], m_v, m_t.reshape(e, 9, h)], dim=1)


def tensor_product_backward_plain(x, w, rhat, y2, g, geometry: bool
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dx, dw, drhat, dy2) of ``(tensor_product_plain(x, w, rhat, y2) * g).sum()``
    by autograd; drhat / dy2 only when ``geometry``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, w, rhat, y2)]
        out = tensor_product_plain(*leaves)
        wrt = leaves if geometry else leaves[:2]
        grads = torch.autograd.grad(out, wrt, g)
    if geometry:
        return grads
    return grads[0], grads[1], None, None
