"""The offline artifact every retriever consumes — port of
``repro/core/index.py``'s :class:`AnchorIndex` and its lifecycle.

- **build**: :meth:`AnchorIndex.build` streams anchor-query row blocks
  through a bulk scorer; with a ``checkpoint_dir`` each finished block is
  saved (``ranc_block_NNNNN.npy`` plus a ``manifest.json``) and a preempted
  build resumes where it stopped, also one the reference began (the same
  files, the same fingerprint of the ids' int32 bytes);
- **save/load**: the reference's versioned layout on the port's
  :class:`~repro_torch.checkpoint.checkpointer.Checkpointer` (one ``.npy``
  per leaf, a manifest, ``index_meta.json``); formats v1–v4 read and
  written, each save stamped with the lowest version its features need;
- **mutate**: :meth:`add_items`, :meth:`remove_items` and
  :meth:`with_capacity` over a padded capacity plus the runtime ``n_valid``
  bound, so shapes never change; a coded payload re-quantizes only the
  tiles a mutation touches and keeps every other tile's bytes.

The item axis is padded to ``capacity``; positions ``[0, n_valid)`` hold
real items (column ``j`` of ``r_anc`` scores item ``item_ids[j]``) and the
tail holds exact-zero columns with ``item_ids == -1``.  Every method
returns a new index and leaves the old one's tensors untouched.

- **shard**: :meth:`AnchorIndex.shard` places the item axis over a
  ``torch.distributed`` mesh (``distributed/sharding.py``'s rules): each
  rank keeps only its column slab of the payload (a coded payload's codes
  with their tile scales), ``item_ids``, ``item_embeddings`` and
  ``item_tokens``, and the small leaves whole.  :meth:`load` with a mesh
  reads only the rank's columns off the disk.  :meth:`topk` then merges
  per-shard candidates over the item shards, the retrievers bind the
  sharded engine, and ``with_capacity`` / ``add_items`` / ``remove_items``
  keep the placement (each rank writes the columns it owns; compaction
  moves columns between ranks one slab broadcast at a time).  Every rank
  of the mesh calls these methods together.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint.checkpointer import Checkpointer
from ..distributed import sharding
from ..distributed.collectives import (ShardCtx, _all_gather, _dims_group, _map_item_ids,
                                       _merge_topk, _owned, _psum_items, _redistribute)
from ..kernels.approx_topk import quant
from ..kernels.approx_topk.ops import approx_topk_op
from ..kernels.approx_topk.quant import QuantizedRanc
from . import cur, prng
from .sampling import NOISE_BLOCK

# bulk_score_fn(query_ids (Q,), item_ids (N,)) -> (Q, N) exact scores
BulkScoreFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

# v2 adds the coded payload (r_codes / r_scales + payload meta), v3 the
# corpus token table (item_tokens), v4 the sub-int8 codes (packed int4,
# fp8 e4m3).  A save stamps the lowest version whose features it uses, so
# a plain fp32 index keeps the v1 layout; every version reads.
INDEX_FORMAT_VERSION = 4
_READABLE_FORMAT_VERSIONS = (1, 2, 3, 4)
_META_FILE = "index_meta.json"
_CKPT_STEP = 0
# the reference's save-time partition specs (JSON form), one per leaf
_LEAF_SPECS = {
    "r_anc": [None, "data"],
    "r_codes": [None, "data"],
    "r_scales": ["data"],
    "anchor_query_ids": [],
    "item_ids": ["data"],
    "n_valid": [],
    "anchor_item_pos": [],
    "u": [],
    "item_embeddings": [None, "data"],
    "item_tokens": ["data", None],
}


def _ids_fingerprint(anchor_query_ids, item_ids) -> str:
    """The reference's fingerprint: sha256 over the ids' int32 bytes."""
    def raw(x):
        return torch.as_tensor(x).to(torch.int32).cpu().numpy().tobytes()
    return hashlib.sha256(raw(anchor_query_ids) + b"|" + raw(item_ids)).hexdigest()[:16]


def build_r_anc(bulk_score_fn: BulkScoreFn, anchor_query_ids, item_ids,
                block_rows: int = 64, checkpoint_dir: Optional[str] = None) -> torch.Tensor:
    """R_anc (k_q, N) fp32 on the item ids' device, in row blocks of
    ``block_rows`` anchor queries.  With ``checkpoint_dir`` every finished
    block is saved (``.npy``) and recorded in a manifest, and finished blocks
    are read back instead of scored.  A manifest whose ``k_q``, ``n_items``,
    ``block_rows`` or id content (fingerprinted) differs from this call's is
    stale: it is cleared with its blocks.  A changed scorer over the same ids
    cannot be detected; use one directory per model."""
    k_q = int(anchor_query_ids.shape[0])
    n_items = int(item_ids.shape[0])
    dev = item_ids.device if isinstance(item_ids, torch.Tensor) else torch.device("cpu")
    n_blocks = (k_q + block_rows - 1) // block_rows
    ids_fp = _ids_fingerprint(anchor_query_ids, item_ids)
    done, manifest_path = set(), None
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        manifest_path = os.path.join(checkpoint_dir, "manifest.json")
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                meta = json.load(f)
            if (meta.get("k_q") == k_q and meta.get("n_items") == n_items
                    and meta.get("block_rows") == block_rows
                    and meta.get("ids_fingerprint") == ids_fp):
                done = set(meta["done_blocks"])
            else:
                clear_build_checkpoints(checkpoint_dir)
    out = torch.empty((k_q, n_items), dtype=torch.float32, device=dev)
    for blk in range(n_blocks):
        lo, hi = blk * block_rows, min((blk + 1) * block_rows, k_q)
        blk_path = (os.path.join(checkpoint_dir, f"ranc_block_{blk:05d}.npy")
                    if checkpoint_dir else None)
        if blk in done and blk_path and os.path.exists(blk_path):
            out[lo:hi] = torch.from_numpy(np.load(blk_path)).to(dev)
            continue
        block = bulk_score_fn(anchor_query_ids[lo:hi], item_ids)
        out[lo:hi] = block
        if checkpoint_dir:
            np.save(blk_path, block.to(torch.float32).cpu().numpy())
            done.add(blk)
            tmp = manifest_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"k_q": k_q, "n_items": n_items, "block_rows": block_rows,
                           "ids_fingerprint": ids_fp, "done_blocks": sorted(done)}, f)
            os.replace(tmp, manifest_path)  # atomic commit
    return out


def clear_build_checkpoints(checkpoint_dir: str) -> None:
    """Drop :func:`build_r_anc`'s row-block files and manifest: on a stale
    manifest, and once the built index is saved (the blocks are
    superseded)."""
    for name in os.listdir(checkpoint_dir):
        if name.startswith("ranc_block_") and name.endswith(".npy"):
            os.remove(os.path.join(checkpoint_dir, name))
    manifest = os.path.join(checkpoint_dir, "manifest.json")
    if os.path.exists(manifest):
        os.remove(manifest)


def _pad_axis(x: torch.Tensor, axis: int, target: int, fill) -> torch.Tensor:
    """``x`` padded with ``fill`` along ``axis`` up to ``target``."""
    n = x.shape[axis]
    if n == target:
        return x
    if n > target:
        raise ValueError(f"cannot shrink axis {axis} from {n} to {target}")
    shape = list(x.shape)
    shape[axis] = target - n
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim=axis)


def _item_axes_for(mesh, k_q: int, grain: int, rules=None) -> Tuple[str, ...]:
    """The mesh dimensions the rules give the item axis: probed with a
    capacity every dimension divides, so on a (data x items) mesh the data
    dimension never inflates the alignment."""
    probe = sharding.spec_for(mesh, ("anchor_q", "items"),
                              (k_q, math.prod(tuple(mesh.shape)) * grain), rules)
    axes = probe[1] if len(probe) > 1 else None
    if axes is None:
        raise ValueError(f"item axis not shardable over mesh {sharding.mesh_dims(mesh)}")
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _shard_grain(r_anc) -> int:
    """A slab's width unit: whole payload tiles and whole noise blocks."""
    return math.lcm(r_anc.tile if isinstance(r_anc, QuantizedRanc) else 1, NOISE_BLOCK)


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
    # optional corpus token table: row j tokenizes the item at position j,
    # kept in positional lockstep with r_anc through every mutation
    item_tokens: Optional[torch.Tensor] = None       # (capacity, item_len) int32
    # the item axis's placement: the DeviceMesh and its dimensions that split
    # it (None: whole on this device).  A sharded index holds this rank's
    # slab of every item-axis tensor; the other tensors are whole.
    mesh: Optional[object] = None
    item_axes: Optional[Tuple[str, ...]] = None

    @property
    def k_q(self) -> int:
        return self.r_anc.shape[0]

    @property
    def local_capacity(self) -> int:
        """Item columns this rank holds (the capacity, unsharded)."""
        return self.r_anc.shape[1]

    @property
    def n_item_shards(self) -> int:
        return 1 if self.mesh is None else sharding.axis_size(self.mesh, self.item_axes)

    @property
    def capacity(self) -> int:
        return self.local_capacity * self.n_item_shards

    def _group(self):
        return _dims_group(self.mesh, self.item_axes)

    @property
    def item_offset(self) -> int:
        """Global position of this rank's column 0."""
        return 0 if self.mesh is None else dist.get_rank(self._group()) * self.local_capacity

    def _ctx(self) -> ShardCtx:
        """The item-shard context of this rank's slab (trivial unsharded)."""
        group = None if self.mesh is None else self._group()
        shard = 0 if group is None else dist.get_rank(group)
        return ShardCtx(group, None, self.local_capacity, self.n_item_shards, shard, 0)

    @property
    def device(self) -> torch.device:
        return self.item_ids.device

    @property
    def payload_dtype(self) -> str:
        return quant.payload_dtype_of(self.r_anc)

    @property
    def payload_nbytes(self) -> int:
        """Device bytes of this rank's payload (codes + scales when coded;
        packed int4 at half a byte a column)."""
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
        """(local_capacity,) bool, True on this rank's real item positions."""
        return self.item_offset + torch.arange(self.local_capacity, device=self.device) < self.n_valid

    def quantize(self, dtype: str = "int8", tile: int = quant.DEFAULT_TILE) -> "AnchorIndex":
        """Re-encode the payload (``int8`` | ``int4`` | ``fp8`` |
        ``bfloat16`` | ``float32``).  The coded dtypes store per-item-tile
        codes and fp32 scales (int8 and fp8 about 4x smaller than fp32,
        packed int4 about 8x); re-encoding a coded index re-quantizes its
        dequantized codes (lossy: keep one encoding per artifact)."""
        if dtype not in quant.PAYLOAD_DTYPES:
            raise ValueError(f"unknown payload dtype '{dtype}' (one of {quant.PAYLOAD_DTYPES})")
        if self.mesh is not None and dtype in quant.CODE_DTYPES:
            # a rank quantizes its own slab: first re-align the slabs to
            # whole tiles (the codes of every column below the old capacity
            # are then those of the unsharded index's)
            unit = self.n_item_shards * math.lcm(tile, NOISE_BLOCK)
            if self.capacity % unit:
                return self.with_capacity(-(-self.capacity // unit) * unit).quantize(dtype, tile)
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
            item_embeddings=move(self.item_embeddings), item_tokens=move(self.item_tokens))

    def gather_item_ids(self, pos: torch.Tensor) -> torch.Tensor:
        """Map engine positions (e.g. ``result.topk_idx``) to external ids
        (a sum over the item shards of a sharded index)."""
        return _map_item_ids(self._ctx(), self.item_ids, pos.to(self.device))

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
              block_rows: int = 64, checkpoint_dir: Optional[str] = None,
              capacity: Optional[int] = None, payload_dtype: str = "float32",
              payload_tile: int = quant.DEFAULT_TILE) -> "AnchorIndex":
        """The offline indexing job: block-streamed over anchor-query rows,
        resumable with a ``checkpoint_dir`` (:func:`build_r_anc`).  The fp32
        blocks are the checkpoint unit; the payload policy applies once to
        the assembled matrix (a tile's scale spans every row)."""
        r_anc = build_r_anc(bulk_score_fn, anchor_query_ids, item_ids, block_rows,
                            checkpoint_dir=checkpoint_dir)
        idx = cls.from_r_anc(r_anc, anchor_query_ids=anchor_query_ids,
                             item_ids=item_ids, capacity=capacity)
        return idx.quantize(payload_dtype, tile=payload_tile)

    def with_item_tokens(self, item_tokens) -> "AnchorIndex":
        """Attach the corpus token table: (n_valid, item_len) or (capacity,
        item_len) int32, row j tokenizing the item at position j.  It is
        padded to capacity with token 0 and moves in positional lockstep with
        the payload through every mutation and save."""
        tok = torch.as_tensor(item_tokens).to(device=self.device, dtype=torch.int32)
        if tok.dim() != 2:
            raise ValueError(f"item_tokens must be (n, item_len); got {tuple(tok.shape)}")
        n = tok.shape[0]
        if n not in (self.n_items, self.capacity):
            raise ValueError(f"item_tokens rows ({n}) must cover the valid items "
                             f"({self.n_items}) or the full capacity ({self.capacity})")
        tok = _pad_axis(tok, 0, self.capacity, 0)
        off = self.item_offset
        return dataclasses.replace(self, item_tokens=tok[off:off + self.local_capacity].clone())

    def with_capacity(self, capacity: int) -> "AnchorIndex":
        """Re-pad the item axis to ``capacity`` (at least ``n_valid``).  A
        coded payload changes only in its padded tail: every tile over the
        valid prefix keeps its codes and scale byte for byte."""
        n = self.n_items
        if capacity < n:
            raise ValueError(f"capacity={capacity} < n_valid={n}")
        if self.mesh is not None:
            return self._sharded_with_capacity(capacity)
        if isinstance(self.r_anc, QuantizedRanc):
            dense = _pad_axis(quant.dequantize(self.r_anc)[:, :n], 1, capacity, 0.0)
            r_anc = quant.requantize_preserving_prefix(self.r_anc, dense, n)
        else:
            r_anc = _pad_axis(self.r_anc[:, :n], 1, capacity, 0)
        emb, tok = self.item_embeddings, self.item_tokens
        return dataclasses.replace(
            self, r_anc=r_anc, item_ids=_pad_axis(self.item_ids[:n], 0, capacity, -1),
            item_embeddings=None if emb is None else _pad_axis(emb[:, :n], 1, capacity, 0.0),
            item_tokens=None if tok is None else _pad_axis(tok[:n], 0, capacity, 0))

    def _sharded_with_capacity(self, capacity: int) -> "AnchorIndex":
        """with_capacity over the mesh: the slab width changes, so columns
        move between ranks (:func:`_redistribute`)."""
        unit = self.n_item_shards * _shard_grain(self.r_anc)
        if capacity % unit:
            raise ValueError(f"a sharded index's capacity must be a multiple of {unit} "
                             f"(item shards x lcm(tile, NOISE_BLOCK)); got {capacity}")
        n, group = self.n_items, self._group()
        local = capacity // self.n_item_shards
        off = dist.get_rank(group) * local
        pos = off + torch.arange(local, device=self.device)
        src = torch.where(pos < n, pos, -1)
        r_anc = self._moved_payload(group, src, n - off)
        emb, tok = self.item_embeddings, self.item_tokens
        return dataclasses.replace(
            self, r_anc=r_anc, item_ids=_redistribute(group, self.item_ids, 0, src, -1),
            item_embeddings=None if emb is None else _redistribute(group, emb, 1, src, 0),
            item_tokens=None if tok is None else _redistribute(group, tok, 0, src, 0))

    def _moved_payload(self, group, src: torch.Tensor, keep_local: int):
        """This rank's new payload slab, column j taken from old global
        column ``src[j]`` (-1: zero).  A coded payload is re-quantized from
        the moved values, and every new tile wholly before local column
        ``keep_local`` gets its old bytes back (the codes and scale that
        were at the same global position), as ``with_capacity`` and
        ``remove_items`` keep an unsharded prefix byte for byte."""
        r = self.r_anc
        if not isinstance(r, QuantizedRanc):
            return _redistribute(group, r, 1, src, 0)
        dense = _redistribute(group, quant.dequantize(r), 1, src, 0.0)
        local = src.shape[0]
        keep = max(0, min(int(keep_local), local))
        tile_src = src[::r.tile]
        old = QuantizedRanc(
            _redistribute(group, r.codes, 1,
                          torch.where(src[::r.packing] >= 0, src[::r.packing] // r.packing, -1),
                          0),
            _redistribute(group, r.scales, 0,
                          torch.where(tile_src >= 0, tile_src // r.tile, -1), 1.0),
            r.tile, r.code_dtype)
        return quant.requantize_preserving_prefix(old, dense, keep)

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
        u = cur.pinv(idx._anchor_columns(), rcond)
        return dataclasses.replace(idx, u=u, item_embeddings=quant.matmul(u, idx.r_anc))

    def _anchor_columns(self) -> torch.Tensor:
        """R_anc[:, anchor_item_pos] (k_q, k_i) fp32; on a sharded index
        each rank takes the anchor columns it owns, zeros elsewhere, summed
        over the item shards."""
        ctx = self._ctx()
        local, owned = _owned(ctx, self.anchor_item_pos)
        cols = quant.take_columns(self.r_anc, local)
        return _psum_items(ctx, torch.where(owned[None, :], cols, 0.0))

    def query_embedding(self, c_anchor: torch.Tensor) -> torch.Tensor:
        """(B, k_i) exact anchor scores -> (B, k_q) latent query embedding."""
        if self.u is None:
            raise ValueError("index has no latents; call with_latents() first")
        return c_anchor @ self.u

    # ---- dynamic corpus (padded capacity + n_valid, shapes never change) ---

    def add_items(self, new_item_ids, cols=None, bulk_score_fn: Optional[BulkScoreFn] = None,
                  new_tokens=None) -> "AnchorIndex":
        """Append items into the padded tail.  ``cols`` is their (k_q, n_new)
        exact score block (``bulk_score_fn(anchor_query_ids, ids)`` when
        omitted); latents extend by ``U @ cols`` (the anchors are untouched).
        An index with a token table needs ``new_tokens`` (n_new, item_len)."""
        new_ids = torch.as_tensor(new_item_ids).to(device=self.device, dtype=torch.int32)
        n_new = int(new_ids.shape[0])
        n0 = self.n_items
        if n0 + n_new > self.capacity:
            raise ValueError(f"add_items overflows capacity {self.capacity} ({n0} + {n_new}); "
                             "rebuild via with_capacity() first")
        new_host = new_ids.cpu().numpy()
        if (new_host < 0).any():
            raise ValueError("add_items: item ids must be >= 0 (-1 is the padding sentinel)")
        if np.unique(new_host).size != n_new:
            raise ValueError("add_items: duplicate item ids in the new batch")
        held = self.item_ids[self.valid_mask()].cpu().numpy()
        clash = torch.tensor([np.intersect1d(new_host, held).size], device=self.device)
        if self.mesh is not None:      # every rank sees the count, so all raise
            dist.all_reduce(clash, group=self._group())
        if int(clash.item()):
            raise ValueError("add_items: some item ids already in the index")
        if cols is None:
            if bulk_score_fn is None:
                raise ValueError("need cols or bulk_score_fn")
            cols = bulk_score_fn(self.anchor_query_ids, new_ids)
        cols = torch.as_tensor(cols).to(device=self.device, dtype=torch.float32)
        if tuple(cols.shape) != (self.k_q, n_new):
            raise ValueError(f"cols {tuple(cols.shape)} != ({self.k_q}, {n_new})")
        tok = self.item_tokens
        if tok is not None:
            if new_tokens is None:
                raise ValueError("this index carries a token table (with_item_tokens); "
                                 "add_items needs new_tokens (n_new, item_len) to keep it "
                                 "position-aligned with the payload")
            new_tokens = torch.as_tensor(new_tokens).to(device=self.device, dtype=torch.int32)
            if tuple(new_tokens.shape) != (n_new, tok.shape[1]):
                raise ValueError(f"new_tokens {tuple(new_tokens.shape)} != "
                                 f"({n_new}, {tok.shape[1]})")
        elif new_tokens is not None:
            raise ValueError("new_tokens given but the index carries no token table; "
                             "attach one first (with_item_tokens)")
        # the part of [n0, n0 + n_new) this rank holds (all of it, unsharded)
        off = self.item_offset
        lo = max(n0, off)
        hi = max(lo, min(n0 + n_new, off + self.local_capacity))
        cols, new_ids = cols[:, lo - n0:hi - n0], new_ids[lo - n0:hi - n0]
        if tok is not None:
            tok = tok.clone()
            tok[lo - off:hi - off] = new_tokens[lo - n0:hi - n0]
        n0, n_add = lo - off, hi - lo
        if not n_add:
            r_anc = self.r_anc
        elif isinstance(self.r_anc, QuantizedRanc):
            r_anc = quant.update_columns(self.r_anc, cols, n0)   # only the touched tiles
        else:
            r_anc = self.r_anc.clone()
            r_anc[:, n0:n0 + n_add] = cols.to(r_anc.dtype)
        item_ids = self.item_ids.clone()
        item_ids[n0:n0 + n_add] = new_ids
        emb = self.item_embeddings
        if emb is not None:
            emb = emb.clone()
            emb[:, n0:n0 + n_add] = (self.u @ cols).to(emb.dtype)
        return dataclasses.replace(
            self, r_anc=r_anc, item_ids=item_ids,
            n_valid=torch.tensor(self.n_items + n_new, dtype=torch.int32, device=self.device),
            item_embeddings=emb, item_tokens=tok)

    def remove_items(self, remove_item_ids) -> "AnchorIndex":
        """Drop items by external id by stable compaction: survivors keep
        their order (a removal equals a rebuild over the survivors), freed
        slots join the padded tail, shapes never change.  A coded payload
        re-quantizes from the first removed column on; the tiles before it
        keep their bytes.  Removing an ANNCUR anchor raises."""
        cap = self.capacity
        ids = torch.as_tensor(remove_item_ids).to(device=self.device, dtype=torch.int32)
        rm = self.valid_mask() & torch.isin(self.item_ids, ids)
        if self.mesh is not None:
            return self._sharded_remove(rm)
        if self.anchor_item_pos is not None and bool(rm[self.anchor_item_pos.long()].any()):
            raise ValueError("remove_items would drop an ANNCUR anchor item; rebuild the "
                             "latents (with_latents) with a surviving anchor set first")
        perm = torch.sort(rm.to(torch.int32), stable=True).indices   # survivors first
        n_rm = int(rm.sum())
        n1 = self.n_items - n_rm
        keep = torch.arange(cap, device=self.device) < n1
        if isinstance(self.r_anc, QuantizedRanc):
            dense = torch.where(keep[None, :], quant.dequantize(self.r_anc)[:, perm], 0.0)
            first_rm = int(torch.argmax(rm.to(torch.int32))) if n_rm else cap
            r_anc = quant.requantize_preserving_prefix(self.r_anc, dense, first_rm)
        else:
            r_anc = torch.where(keep[None, :], self.r_anc[:, perm],
                                torch.zeros((), dtype=self.r_anc.dtype, device=self.device))
        emb, tok = self.item_embeddings, self.item_tokens
        new = dataclasses.replace(
            self, r_anc=r_anc,
            item_ids=torch.where(keep, self.item_ids[perm], -1),
            n_valid=torch.tensor(n1, dtype=torch.int32, device=self.device),
            item_embeddings=None if emb is None else torch.where(keep[None, :], emb[:, perm], 0.0),
            item_tokens=None if tok is None else torch.where(keep[:, None], tok[perm], 0))
        if self.anchor_item_pos is not None:
            inv = torch.argsort(perm)                     # old position -> new
            new = dataclasses.replace(
                new, anchor_item_pos=inv[self.anchor_item_pos.long()].to(torch.int32))
        return new

    def _sharded_remove(self, rm_local: torch.Tensor) -> "AnchorIndex":
        """remove_items over the mesh: the global removal mask is gathered
        (one bool a column), and the stable compaction moves columns
        between ranks (:func:`_redistribute`)."""
        group = self._group()
        rm = _all_gather(group, rm_local.to(torch.int32), 0).to(torch.bool)
        if self.anchor_item_pos is not None and bool(rm[self.anchor_item_pos.long()].any()):
            raise ValueError("remove_items would drop an ANNCUR anchor item; rebuild the "
                             "latents (with_latents) with a surviving anchor set first")
        perm = torch.sort(rm.to(torch.int32), stable=True).indices   # survivors first
        n_rm = int(rm.sum())
        n1 = self.n_items - n_rm
        off = self.item_offset
        pos = off + torch.arange(self.local_capacity, device=self.device)
        src = torch.where(pos < n1, perm[pos], -1)
        first_rm = int(torch.argmax(rm.to(torch.int32))) if n_rm else self.capacity
        emb, tok = self.item_embeddings, self.item_tokens
        new = dataclasses.replace(
            self, r_anc=self._moved_payload(group, src, first_rm - off),
            item_ids=_redistribute(group, self.item_ids, 0, src, -1),
            n_valid=torch.tensor(n1, dtype=torch.int32, device=self.device),
            item_embeddings=None if emb is None else _redistribute(group, emb, 1, src, 0),
            item_tokens=None if tok is None else _redistribute(group, tok, 0, src, 0))
        if self.anchor_item_pos is not None:
            inv = torch.argsort(perm)                     # old position -> new
            new = dataclasses.replace(
                new, anchor_item_pos=inv[self.anchor_item_pos.long()].to(torch.int32))
        return new

    # ---- persistence (the reference's versioned Checkpointer layout) -------

    def _tree(self) -> dict:
        t = {"anchor_query_ids": self.anchor_query_ids, "item_ids": self.item_ids,
             "n_valid": self.n_valid}
        if isinstance(self.r_anc, QuantizedRanc):
            t["r_codes"], t["r_scales"] = self.r_anc.codes, self.r_anc.scales
        else:
            t["r_anc"] = self.r_anc
        if self.anchor_item_pos is not None:
            t["anchor_item_pos"] = self.anchor_item_pos
        if self.has_latents:
            t.update(u=self.u, item_embeddings=self.item_embeddings)
        if self.item_tokens is not None:
            t["item_tokens"] = self.item_tokens
        return t

    def save(self, path: str) -> None:
        """Persist atomically under ``path``: one ``.npy`` per leaf and a
        manifest with each leaf's reference partition spec (``step_0/``),
        then ``index_meta.json``, written as the reference writes them.

        A sharded index is saved by every rank of its mesh together, and
        the files are byte for byte those the unsharded save of the same
        index (the same capacity) writes: each item shard's first rank
        writes its columns of every item-axis leaf into the one global
        ``.npy``, the mesh's first rank writes the rest; no rank holds
        another's columns (``Checkpointer.save_sharded``).  The manifest
        records the item-axis leaves' placement, as the reference's does."""
        tree = self._tree()
        specs = {k: _LEAF_SPECS[k] for k in tree}
        if self.mesh is None:
            Checkpointer(path).save(_CKPT_STEP, tree, specs)
            self._write_meta(path)
            return
        sharding.check_mesh_device(self.mesh, self.mesh.device_type)
        axes = list(self.item_axes)
        off, cap = self.item_offset, self.capacity
        r = self.r_anc
        pack = r.packing if isinstance(r, QuantizedRanc) else 1
        tile = r.tile if isinstance(r, QuantizedRanc) else 1
        placed = {"r_anc": (1, cap, off), "r_codes": (1, cap // pack, off // pack),
                  "r_scales": (0, cap // tile, off // tile), "item_ids": (0, cap, off),
                  "item_embeddings": (1, cap, off), "item_tokens": (0, cap, off)}
        placed = {k: v for k, v in placed.items() if k in tree}
        for k, (axis, _, _) in placed.items():
            specs[k] = [None] * axis + [axes] + ([None] if k == "item_tokens" else [])
        everyone = _dims_group(self.mesh, tuple(self.mesh.mesh_dim_names))
        others = tuple(a for a in self.mesh.mesh_dim_names if a not in self.item_axes)
        first_copy = not others or dist.get_rank(_dims_group(self.mesh, others)) == 0
        Checkpointer(path).save_sharded(_CKPT_STEP, tree, specs, placed, everyone, first_copy,
                                        on_commit=lambda: self._write_meta(path))

    def _write_meta(self, path: str) -> None:
        """``index_meta.json``, stamped with the lowest format version whose
        on-disk features this index uses."""
        coded = isinstance(self.r_anc, QuantizedRanc)
        if coded and self.r_anc.code_dtype != "int8":
            version = 4          # sub-int8 codes: packed int4 / fp8 e4m3
        elif self.item_tokens is not None:
            version = 3
        else:
            version = 2 if coded else 1
        payload_meta = {"dtype": self.payload_dtype,
                        "tile": self.r_anc.tile if coded else None}
        if coded:
            payload_meta["code_dtype"] = self.r_anc.code_dtype
            payload_meta["n_cols"] = self.r_anc.n_cols
        meta = {
            "format_version": version,
            "k_q": self.k_q,
            "capacity": self.capacity,
            "n_items": self.n_items,
            # the reference's QuantizedRanc reports float32
            "dtype": "float32" if coded else str(self.r_anc.dtype).replace("torch.", ""),
            "has_latents": self.has_latents,
            "payload": payload_meta,
        }
        tmp = os.path.join(path, _META_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(path, _META_FILE))

    @classmethod
    def load(cls, path: str, device=None, mesh=None) -> "AnchorIndex":
        """Load a saved index (format v1–v4, written by the port or the
        reference) onto ``device`` (the card unless ``device="cpu"``).

        With a ``mesh`` the item axis is placed as :meth:`shard` places it
        (``load(path, mesh)`` equals ``load(path).shard(mesh)``), and each
        rank reads only its columns of the item-axis leaves off the disk
        (``Checkpointer.restore(slices=)``), so no rank ever holds the whole
        payload; ``device`` defaults to the mesh's.  The reference re-resolves
        each leaf's save-time spec on the new mesh instead; the port places
        by the ``items`` rule, which puts the item axis on a serving mesh's
        ``items`` dimension."""
        meta_path = os.path.join(path, _META_FILE)
        if not os.path.exists(meta_path):
            raise FileNotFoundError(f"no AnchorIndex at {path!r} ({_META_FILE} missing)")
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("format_version") not in _READABLE_FORMAT_VERSIONS:
            raise ValueError(
                f"unsupported AnchorIndex format version {meta.get('format_version')} "
                f"(this build reads versions {_READABLE_FORMAT_VERSIONS})")
        payload = meta.get("payload") or {}
        # v2/v3 meta predates sub-int8 codes: default to the int8 layout
        tile = int(payload.get("tile") or quant.DEFAULT_TILE)
        code_dtype = str(payload.get("code_dtype") or "int8")
        ck = Checkpointer(path)
        if mesh is None:
            tree = ck.restore(_CKPT_STEP, device=device)
            if "r_codes" in tree:
                tree["r_anc"] = QuantizedRanc(
                    codes=tree.pop("r_codes"), scales=tree.pop("r_scales"), tile=tile,
                    code_dtype=code_dtype, n_cols=int(payload.get("n_cols", -1)))
            return cls(**tree)
        if device is None:
            from ..launch.mesh import mesh_device
            device = mesh_device(mesh)
        coded = payload.get("tile") is not None
        cap, n = int(meta["capacity"]), int(meta["n_items"])
        grain = math.lcm(tile if coded else 1, NOISE_BLOCK)
        axes = _item_axes_for(mesh, int(meta["k_q"]), grain)
        n_shards = sharding.axis_size(mesh, axes)
        unit = n_shards * grain
        aligned = -(-cap // unit) * unit
        local = aligned // n_shards
        off = dist.get_rank(_dims_group(mesh, axes)) * local
        lo, hi = min(off, cap), min(off + local, cap)   # the saved columns this rank holds
        pack = 2 if code_dtype == "int4" else 1
        slices = {"r_anc": (1, lo, hi), "r_codes": (1, lo // pack, -(-hi // pack)),
                  "r_scales": (0, lo // tile, -(-hi // tile)), "item_ids": (0, lo, hi),
                  "item_embeddings": (1, lo, hi), "item_tokens": (0, lo, hi)}
        tree = ck.restore(_CKPT_STEP, device=device, slices=slices)
        fills = {"r_anc": (1, 0), "item_ids": (0, -1), "item_embeddings": (1, 0),
                 "item_tokens": (0, 0)}
        for key, (axis, fill) in fills.items():
            if key in tree:
                tree[key] = _pad_axis(tree[key], axis, local, fill)
        if "r_codes" in tree:
            codes = _pad_axis(tree.pop("r_codes"), 1, local // pack, 0)
            scales = _pad_axis(tree.pop("r_scales"), 0, local // tile, 1.0)
            tree["r_anc"] = QuantizedRanc(codes, scales, tile, code_dtype)
        idx = cls(**tree, mesh=mesh, item_axes=axes)
        if aligned == cap:
            return idx
        # shard() re-pads an unaligned capacity first (with_capacity): the
        # columns past the valid prefix become padding and the tiles from the
        # prefix's last one on are re-quantized, here on this rank's columns
        pos = off + torch.arange(local, device=idx.device)
        return dataclasses.replace(
            idx, r_anc=idx._moved_payload_local(torch.where(pos < n, pos - off, -1), n - off),
            item_ids=torch.where(pos < n, idx.item_ids, -1),
            item_embeddings=(None if idx.item_embeddings is None
                             else torch.where(pos < n, idx.item_embeddings, 0)),
            item_tokens=(None if idx.item_tokens is None
                         else torch.where((pos < n)[:, None], idx.item_tokens, 0)))

    # ---- sharding ------------------------------------------------------------

    def shard(self, mesh, rules=None) -> "AnchorIndex":
        """Place the item axis over ``mesh`` (a ``DeviceMesh``; every rank
        calls this with the same index).  The dimensions come from the
        ``items`` rule (``distributed/sharding.py``): ``items`` on a serving
        mesh.  Capacity is re-padded to a multiple of ``n_item_shards x
        lcm(tile, NOISE_BLOCK)`` so every slab holds whole quantization tiles
        (with their scales) and whole blocks of the engine's noise field;
        each rank then keeps its column slab of the payload, ``item_ids``,
        ``item_embeddings`` and ``item_tokens``.  The placement lives on the
        index (``mesh``, ``item_axes``) and survives mutation."""
        if self.mesh is not None:
            if self.mesh is mesh:
                return self
            raise ValueError("this index is already sharded over another mesh")
        axes = _item_axes_for(mesh, self.k_q, _shard_grain(self.r_anc), rules)
        n_shards = sharding.axis_size(mesh, axes)
        unit = n_shards * _shard_grain(self.r_anc)
        idx = self
        if idx.capacity % unit:
            idx = idx.with_capacity(-(-idx.capacity // unit) * unit)
        local = idx.capacity // n_shards
        off = dist.get_rank(_dims_group(mesh, axes)) * local
        cols = slice(off, off + local)
        r = idx.r_anc
        if isinstance(r, QuantizedRanc):
            r_anc = QuantizedRanc(r.codes[:, off // r.packing:(off + local) // r.packing].clone(),
                                  r.scales[off // r.tile:(off + local) // r.tile].clone(),
                                  r.tile, r.code_dtype)
        else:
            r_anc = r[:, cols].clone()
        emb, tok = idx.item_embeddings, idx.item_tokens
        return dataclasses.replace(
            idx, r_anc=r_anc, item_ids=idx.item_ids[cols].clone(),
            item_embeddings=None if emb is None else emb[:, cols].clone(),
            item_tokens=None if tok is None else tok[cols].clone(),
            mesh=mesh, item_axes=axes)

    def _item_sharding(self):
        """(mesh, item axes) of a sharded index, else (None, None)."""
        return (self.mesh, self.item_axes) if self.mesh is not None else (None, None)

    def _moved_payload_local(self, src_local: torch.Tensor, keep_local: int):
        """This rank's payload with column j taken from its own column
        ``src_local[j]`` (-1: zero), a coded one re-quantized with the tiles
        before ``keep_local`` restored (the local form of ``with_capacity``)."""
        r = self.r_anc
        keep = src_local >= 0
        if not isinstance(r, QuantizedRanc):
            return torch.where(keep[None, :], r, torch.zeros((), dtype=r.dtype, device=r.device))
        dense = torch.where(keep[None, :], quant.dequantize(r), 0.0)
        return quant.requantize_preserving_prefix(
            r, dense, max(0, min(int(keep_local), self.local_capacity)))

    def engine_search(self, score_fn, query, cfg, key=None, **kw):
        """One full multi-round search over this index (the sharded engine
        on a sharded index, every rank calling); for repeated queries hold an
        ``AdaCURRetriever.from_index`` instead."""
        from .engine import AdaCURRetriever

        return AdaCURRetriever.from_index(self, score_fn, cfg).search(query, key, **kw)

    def topk(self, e_q: torch.Tensor, k: int, tile: int = 512):
        """Top-k of ``e_q @ R_anc`` over the valid items -> (values, positions),
        through the fused op (the CUDA kernel on the card).  The padded tail
        is suppressed by the ``n_valid`` bound, the same items as the
        reference's broadcast valid mask, without a (B, capacity) mask.

        On a sharded index each rank runs the fused op over its slab, with
        its invalid columns masked, and the per-shard candidates merge over
        the item shards by (max value, min global id); every rank passes the
        same ``e_q`` and gets the global result."""
        if self.mesh is None:
            n_valid = self.n_items if self.n_items < self.capacity else None
            return approx_topk_op(e_q, self.r_anc, None, k, tile=tile, n_valid=n_valid)
        local = self.local_capacity
        if k > local:
            raise ValueError(f"k={k} > per-shard items {local}")
        mask = (~self.valid_mask())[None, :].expand(e_q.shape[0], local).contiguous()
        v, i = approx_topk_op(e_q, self.r_anc, None, k, tile=min(tile, local), mask=mask)
        return _merge_topk(self._ctx(), v, i + self.item_offset, k)
