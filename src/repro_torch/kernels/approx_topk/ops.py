"""Public fused approx-score -> top-k op — port of
``repro/kernels/approx_topk/ops.py``.

Two backends with the same semantics:

- ``cuda``: the hand-written kernel (``kernel.approx_topk_cuda``);
- ``torch``: the plain tiled version, the twin of the reference's
  ``_scan_topk_tiles``: per item tile a (B, tile) score slab, masked, keeps
  its index-stable top-k, and the per-tile lists merge by (max value, min
  id).  It is the executable spec the CPU tests hold against the reference.

``impl="auto"`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; nothing falls back from one to the other.

Ties: exact score ties break by ascending item id in both backends, and a
row with fewer than k unmasked items returns its lowest masked ids (value
NEG_INF), distinct and ascending — the reference's scan backend, not its
Pallas kernel, which repeats an id there.
"""

from __future__ import annotations

import torch

from .kernel import approx_topk_cuda
from .quant import QuantizedRanc, unpack_int4
from .select import NEG_INF, stable_topk, topk_value_id


def rebalanced_tile(n: int, tile: int) -> int:
    """The reference's tile rebalancing: same tile count, even widths."""
    n_tiles = -(-n // tile)
    return -(-n // n_tiles)


def anchor_mask(anchors, b: int, n: int, device) -> torch.Tensor:
    """(B, N) bool with True at each row's anchor ids (-1 and out-of-range
    ids are ignored) — the same suppression as the per-tile id compare."""
    hit = torch.zeros((b, n + 1), dtype=torch.bool, device=device)
    a = anchors.long()
    a = torch.where((a >= 0) & (a < n), a, n)
    hit.scatter_(1, a, True)
    return hit[:, :n]


class PlainTiles:
    """Per-tile fp32 GEMM slabs of a payload, shared by the plain versions
    of both ops so their scores are computed by identical calls.  Each tile
    reads its slice of the payload as stored and widens it to fp32 (bf16
    and fp8 by a cast; a packed int4 tile is tile/2 bytes, unpacked, as
    the reference's ``_scan_topk_tiles`` does); the tile is even for int4
    so its boundaries fall on bytes."""

    def __init__(self, e_q, r_anc, tile: int):
        self.e_q = e_q.to(torch.float32)
        if isinstance(r_anc, QuantizedRanc):
            self.codes, self.scales = r_anc.codes, r_anc.col_scales()
            self.pack = r_anc.packing
        else:
            self.codes, self.scales, self.pack = r_anc, None, 1
        self.n = r_anc.shape[1]
        self.tile = rebalanced_tile(self.n, tile)
        self.tile += -self.tile % self.pack

    def bounds(self):
        for lo in range(0, self.n, self.tile):
            yield lo, min(self.n, lo + self.tile)

    def gemm(self, lo: int, hi: int) -> torch.Tensor:
        if self.pack == 2:
            r = unpack_int4(self.codes[:, lo // 2:(hi + 1) // 2])[:, :hi - lo]
        else:
            r = self.codes[:, lo:hi]
        return self.e_q @ r.to(torch.float32)

    def scaled(self, gemm, lo: int, hi: int) -> torch.Tensor:
        return gemm if self.scales is None else gemm * self.scales[lo:hi][None, :]


def tile_select(s, keep, lo: int, k: int):
    """Masked index-stable top-k of one (B, T) slab -> global ids."""
    s = torch.where(keep, s, torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    v, i = stable_topk(s, min(k, s.shape[1]))
    return v, i + lo


def merge_lists(parts, k: int):
    """Merge per-tile (vals, ids) lists by (max value, min id)."""
    v = torch.cat([p[0] for p in parts], dim=1)
    i = torch.cat([p[1] for p in parts], dim=1)
    return topk_value_id(v, i, k)


def approx_topk_plain(e_q, r_anc, anchors, k: int, *, tile: int = 512,
                      noise=None, mask=None, n_valid=None):
    """The plain PyTorch version of the fused op (any device)."""
    tiles = PlainTiles(e_q, r_anc, tile)
    b, n = e_q.shape[0], tiles.n
    n_eff = n if n_valid is None else min(int(n_valid), n)
    hit = mask
    if anchors is not None:
        am = anchor_mask(anchors, b, n, e_q.device)
        hit = am if hit is None else hit | am
    parts = []
    for lo, hi in tiles.bounds():
        s = tiles.scaled(tiles.gemm(lo, hi), lo, hi)
        if noise is not None:
            s = s + noise[:, lo:hi].to(torch.float32)
        keep = (torch.arange(lo, hi, device=e_q.device) < n_eff)[None, :]
        if hit is not None:
            keep = keep & ~hit[:, lo:hi]
        parts.append(tile_select(s, keep, lo, k))
    return merge_lists(parts, k)


def approx_topk_op(e_q, r_anc, anchors, k: int, *, tile: int = 512,
                   interpret: bool = True, noise=None, mask=None,
                   n_valid=None, impl: str = "auto"):
    """Fused  top-k(mask(e_q @ R_anc [+ noise]))  ->  (vals (B,k), idx (B,k)).

    ``r_anc`` is a (k_q, N) fp32 or bf16 tensor or a
    :class:`QuantizedRanc` (int8, fp8 or packed int4 codes);
    ``anchors`` (B, A) are suppressed ids (pad with -1; None = none);
    ``mask`` (B, N) bool suppresses where True; ``noise`` (B, N) is added
    before masking; ``n_valid`` suppresses ids >= n_valid.  ``tile`` is the
    plain version's item tile; ``interpret`` is accepted for signature
    parity with the reference and has no effect.
    """
    if impl == "auto":
        impl = "cuda" if e_q.is_cuda else "torch"
    if impl == "cuda":
        return approx_topk_cuda(e_q, r_anc, anchors, k, noise=noise,
                                mask=mask, n_valid=n_valid)
    if impl == "torch":
        return approx_topk_plain(e_q, r_anc, anchors, k, tile=tile,
                                 noise=noise, mask=mask, n_valid=n_valid)
    raise ValueError(f"unknown impl '{impl}' (auto|cuda|torch)")
