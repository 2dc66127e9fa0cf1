"""CUR decomposition primitives — port of ``repro/core/cur.py``.

The pseudo-inverse and its incremental (bordered) extension, batched over
the query dimension directly (the reference vmaps the single-query update,
``engine.py:626``).  Linear solves go through ``torch.linalg.solve_ex``
without error checks, so a singular system yields non-finite values exactly
as XLA's LU does, and the finite guard below takes over.  Algorithm 2's
dense reconstruction (``query_embedding``, ``approx_scores``,
``cur_reconstruction``) serves ANNCUR's latents and the tests.
"""

from __future__ import annotations

import torch


def pinv(a: torch.Tensor, rcond: float = 1e-6) -> torch.Tensor:
    """Moore-Penrose pseudo-inverse (SVD-based, batched over leading dims)."""
    return torch.linalg.pinv(a, rtol=rcond)


def gather_anchor_columns(r_anc: torch.Tensor, anchor_idx: torch.Tensor) -> torch.Tensor:
    """R_anc[:, I_anc] for per-query anchor sets: r_anc (k_q, N), anchor_idx
    (B, k) -> (B, k_q, k)."""
    return r_anc[:, anchor_idx.long()].permute(1, 0, 2).contiguous()


def _solve(a, b):
    return torch.linalg.solve_ex(a, b, check_errors=False).result


def _bordered_blocks(a, p, b, ridge: float):
    """(D, K) of the bordering update for M = [A | B], batched (B, ...).

    K is the full-column-rank branch ``(CᵀC + ridge I)⁻¹ Cᵀ`` blended per
    column with the Greville branch ``(I + DᵀD)⁻¹ Dᵀ P``; a non-finite
    solve (duplicate new columns) falls back to the Greville branch
    (reference guard, ``cur.py:123``).

    The residual C = B - A P B is projected off A's span twice (the
    reference does it once).  A new anchor column lies close to that span,
    so one projection leaves C dominated by P's rounding error, which the
    ridge solve then amplifies round over round: one ulp of the payload
    moved a 40-anchor, 4-round fp32 search's top-k
    (``tests/test_torch_engine.py``).  The second pass removes that error
    (the "twice is enough" rule of Gram-Schmidt)."""
    d = p @ b                                          # (B, n, s)
    c = b - a @ d                                      # (B, m, s)
    d2 = p @ c
    d = d + d2
    c = c - a @ d2
    ct = c.transpose(-1, -2)
    gram = ct @ c
    s = gram.shape[-1]
    eye = torch.eye(s, dtype=gram.dtype, device=gram.device)
    scale = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1) / s + 1.0
    k1 = _solve(gram + ridge * scale[..., None, None] * eye, ct)
    dt = d.transpose(-1, -2)
    k2 = _solve(eye + dt @ d, dt @ p)
    k1 = torch.where(torch.isfinite(k1), k1, k2)
    c_norm = (c * c).sum(-2)
    b_norm = (b * b).sum(-2) + 1e-30
    w = (c_norm > 1e-10 * b_norm).to(k1.dtype)[..., :, None]
    return d, w * k1 + (1.0 - w) * k2


def block_pinv_extend(a, p, b, ridge: float = 1e-8):
    """Extend ``P = pinv(A)`` to ``pinv([A | B])`` by the bordering identity."""
    d, k = _bordered_blocks(a, p, b, ridge)
    return torch.cat([p - d @ k, k], dim=-2)


def block_pinv_extend_static(a_full, p_full, b, start: int, ridge: float = 1e-8):
    """Shape-invariant bordering update over preallocated buffers: ``a_full``
    (B, m, K) holds the columns filled so far in [0, start) with exact zeros
    beyond, ``p_full`` (B, K, m) their pinv in rows [0, start); the new block
    ``b`` (B, m, s) writes its rows into [start, start + s)."""
    d, k = _bordered_blocks(a_full, p_full, b, ridge)
    top = p_full - d @ k
    top[..., start:start + k.shape[-2], :] = k
    return top


def incremental_pinv_init(a0, rcond: float = 1e-6):
    """pinv of the first anchor block (computed once, full SVD)."""
    return pinv(a0, rcond)


def query_embedding(r_anc_cols: torch.Tensor, c_test: torch.Tensor,
                    rcond: float = 1e-6) -> torch.Tensor:
    """e_q = C_test @ pinv(R_anc[:, I_anc]): (B, k_q, k) columns and (B, k)
    exact scores -> (B, k_q); ``S_hat = e_q @ R_anc`` is then one GEMM."""
    return torch.einsum("bk,bkq->bq", c_test, pinv(r_anc_cols, rcond))


def approx_scores(r_anc: torch.Tensor, c_test: torch.Tensor, anchor_idx: torch.Tensor,
                  rcond: float = 1e-6) -> torch.Tensor:
    """Algorithm 2: approximate scores of all N items for each query from
    its (B, k) anchor ids and their exact scores -> (B, N)."""
    cols = gather_anchor_columns(r_anc, anchor_idx)
    return query_embedding(cols, c_test, rcond) @ r_anc


def cur_reconstruction(r_anc: torch.Tensor, anchor_idx: torch.Tensor, rows: torch.Tensor,
                       rcond: float = 1e-6) -> torch.Tensor:
    """The CUR reconstruction C U R of (B, k) exact score rows on the anchor
    columns -> their (B, N) approximation (ANNCUR's offline index)."""
    return approx_scores(r_anc, rows, anchor_idx, rcond)
