"""The offline artifact every retriever consumes — port of the in-memory
part of ``repro/core/index.py``'s :class:`AnchorIndex`.

The item axis is padded to ``capacity``; positions ``[0, n_valid)`` hold
real items (column ``j`` of ``r_anc`` scores item ``item_ids[j]``) and the
tail holds exact-zero columns with ``item_ids == -1``.  ANNCUR's anchors
and latents (``with_anchors``, ``with_latents``) and the single-device
``topk`` are here; save/load, the resumable ``checkpoint_dir`` build,
mutation and sharding are later slices (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch

from ..kernels.approx_topk import quant
from ..kernels.approx_topk.ops import approx_topk_op
from ..kernels.approx_topk.quant import QuantizedRanc
from . import cur, prng

# bulk_score_fn(query_ids (Q,), item_ids (N,)) -> (Q, N) exact scores
BulkScoreFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def build_r_anc(bulk_score_fn: BulkScoreFn, anchor_query_ids, item_ids,
                block_rows: int = 64) -> torch.Tensor:
    """R_anc (k_q, N), streamed in blocks of anchor-query rows into one
    preallocated buffer on the scorer's device."""
    k_q = int(anchor_query_ids.shape[0])
    out = None
    for lo in range(0, k_q, block_rows):
        block = bulk_score_fn(anchor_query_ids[lo:lo + block_rows], item_ids)
        if out is None:
            out = torch.empty((k_q, block.shape[1]), dtype=torch.float32,
                              device=block.device)
        out[lo:lo + block.shape[0]] = block
    return out


@dataclass
class AnchorIndex:
    r_anc: Union[torch.Tensor, QuantizedRanc]   # (k_q, capacity) payload
    anchor_query_ids: torch.Tensor              # (k_q,) int32
    item_ids: torch.Tensor                      # (capacity,) int32, -1 padding
    n_valid: torch.Tensor                       # () int32 real item count
    # optional ANNCUR latents (arXiv 2210.12579)
    anchor_item_pos: Optional[torch.Tensor] = None   # (k_i,) int32 anchor positions
    u: Optional[torch.Tensor] = None                 # (k_i, k_q) pinv(R_anc[:, I_anc])
    item_embeddings: Optional[torch.Tensor] = None   # (k_i, capacity) U @ R_anc

    @property
    def k_q(self) -> int:
        return self.r_anc.shape[0]

    @property
    def capacity(self) -> int:
        return self.r_anc.shape[1]

    @property
    def device(self) -> torch.device:
        return self.item_ids.device

    @property
    def payload_dtype(self) -> str:
        return quant.payload_dtype_of(self.r_anc)

    @property
    def payload_nbytes(self) -> int:
        """Device bytes of the payload (codes + scales when coded; packed
        int4 at half a byte a column)."""
        if isinstance(self.r_anc, QuantizedRanc):
            return self.r_anc.nbytes
        return self.r_anc.numel() * self.r_anc.element_size()

    @property
    def n_items(self) -> int:
        return int(self.n_valid)

    @property
    def has_latents(self) -> bool:
        return self.item_embeddings is not None

    def valid_mask(self) -> torch.Tensor:
        """(capacity,) bool, True on real item positions."""
        return torch.arange(self.capacity, device=self.device) < self.n_valid

    def quantize(self, dtype: str = "int8", tile: int = quant.DEFAULT_TILE) -> "AnchorIndex":
        """Re-encode the payload (``int8`` | ``int4`` | ``fp8`` |
        ``bfloat16`` | ``float32``).  The coded dtypes store per-item-tile
        codes and fp32 scales (int8 and fp8 about 4x smaller than fp32,
        packed int4 about 8x); re-encoding a coded index re-quantizes its
        dequantized codes (lossy: keep one encoding per artifact)."""
        if dtype not in quant.PAYLOAD_DTYPES:
            raise ValueError(f"unknown payload dtype '{dtype}' (one of {quant.PAYLOAD_DTYPES})")
        cur = self.r_anc
        coded = isinstance(cur, QuantizedRanc)
        if dtype == self.payload_dtype and (not coded or cur.tile == tile):
            return self
        dense = quant.dequantize(cur) if coded else cur.to(torch.float32)
        if dtype in quant.CODE_DTYPES:
            new = quant.quantize_ranc(dense, tile, code_dtype=dtype)
        elif dtype == "bfloat16":
            new = dense.to(torch.bfloat16)
        else:
            new = dense
        return dataclasses.replace(self, r_anc=new)

    def to(self, device) -> "AnchorIndex":
        """The same index with every tensor on ``device``."""
        move = lambda t: None if t is None else t.to(device)  # noqa: E731
        return dataclasses.replace(
            self, r_anc=self.r_anc.to(device), anchor_query_ids=move(self.anchor_query_ids),
            item_ids=move(self.item_ids), n_valid=move(self.n_valid),
            anchor_item_pos=move(self.anchor_item_pos), u=move(self.u),
            item_embeddings=move(self.item_embeddings))

    def gather_item_ids(self, pos: torch.Tensor) -> torch.Tensor:
        """Map engine positions (e.g. ``result.topk_idx``) to external ids."""
        return self.item_ids[pos.long()]

    @classmethod
    def from_r_anc(cls, r_anc: torch.Tensor, anchor_query_ids=None,
                   item_ids=None, capacity: Optional[int] = None) -> "AnchorIndex":
        """Wrap a dense (k_q, N) score matrix, padding the item axis to
        ``capacity`` (defaults to N)."""
        k_q, n = r_anc.shape
        dev = r_anc.device
        capacity = n if capacity is None else int(capacity)
        if capacity < n:
            raise ValueError(f"capacity={capacity} < n_items={n}")
        if anchor_query_ids is None:
            anchor_query_ids = torch.arange(k_q, dtype=torch.int32, device=dev)
        if item_ids is None:
            item_ids = torch.arange(n, dtype=torch.int32, device=dev)
        if item_ids.shape[0] != n:
            raise ValueError(f"item_ids {tuple(item_ids.shape)} != n_items {n}")
        r_anc = r_anc.to(torch.float32)
        if capacity > n:
            r_anc = torch.nn.functional.pad(r_anc, (0, capacity - n))
        return cls(
            r_anc=r_anc,
            anchor_query_ids=anchor_query_ids.to(device=dev, dtype=torch.int32),
            item_ids=torch.nn.functional.pad(
                item_ids.to(device=dev, dtype=torch.int32), (0, capacity - n), value=-1),
            n_valid=torch.tensor(n, dtype=torch.int32, device=dev),
        )

    @classmethod
    def build(cls, bulk_score_fn: BulkScoreFn, anchor_query_ids, item_ids,
              block_rows: int = 64, capacity: Optional[int] = None,
              payload_dtype: str = "float32",
              payload_tile: int = quant.DEFAULT_TILE) -> "AnchorIndex":
        """The offline indexing job, block-streamed over anchor-query rows."""
        r_anc = build_r_anc(bulk_score_fn, anchor_query_ids, item_ids, block_rows)
        idx = cls.from_r_anc(r_anc, anchor_query_ids=anchor_query_ids,
                             item_ids=item_ids, capacity=capacity)
        return idx.quantize(payload_dtype, tile=payload_tile)

    # ---- ANNCUR latents ----------------------------------------------------

    def with_anchors(self, k_anchor: Optional[int] = None, key=None,
                     anchor_pos=None) -> "AnchorIndex":
        """Fix the ANNCUR anchor item positions without latents: ``anchor_pos``,
        or ``k_anchor`` positions drawn uniformly from the valid prefix by
        ``prng.choice(key, ...)``, JAX's draw bit for bit, so the same key
        picks the reference's anchors."""
        if anchor_pos is None:
            if key is None or k_anchor is None:
                raise ValueError("need (k_anchor, key) or explicit anchor_pos")
            anchor_pos = prng.choice(key, self.n_items, (int(k_anchor),), replace=False)
        pos = torch.as_tensor(anchor_pos).to(device=self.device, dtype=torch.int32)
        return dataclasses.replace(self, anchor_item_pos=pos, u=None, item_embeddings=None)

    def with_latents(self, k_anchor: Optional[int] = None, key=None, anchor_pos=None,
                     rcond: float = 1e-6) -> "AnchorIndex":
        """:meth:`with_anchors` plus ``U = pinv(R_anc[:, I_anc])`` and the
        latent item embeddings ``E_I = U @ R_anc``."""
        idx = self.with_anchors(k_anchor=k_anchor, key=key, anchor_pos=anchor_pos)
        u = cur.pinv(quant.take_columns(idx.r_anc, idx.anchor_item_pos), rcond)
        return dataclasses.replace(idx, u=u, item_embeddings=quant.matmul(u, idx.r_anc))

    def query_embedding(self, c_anchor: torch.Tensor) -> torch.Tensor:
        """(B, k_i) exact anchor scores -> (B, k_q) latent query embedding."""
        if self.u is None:
            raise ValueError("index has no latents; call with_latents() first")
        return c_anchor @ self.u

    def topk(self, e_q: torch.Tensor, k: int, tile: int = 512):
        """Top-k of ``e_q @ R_anc`` over the valid items -> (values, positions),
        through the fused op (the CUDA kernel on the card).  The padded tail
        is suppressed by the ``n_valid`` bound, the same items as the
        reference's broadcast valid mask, without a (B, capacity) mask."""
        n_valid = self.n_items if self.n_items < self.capacity else None
        return approx_topk_op(e_q, self.r_anc, None, k, tile=tile, n_valid=n_valid)
