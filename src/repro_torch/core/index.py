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
returns a new index and leaves the old one's tensors untouched.  Sharding
(``shard``, ``load(mesh)``) is a later slice (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..checkpoint.checkpointer import Checkpointer
from ..kernels.approx_topk import quant
from ..kernels.approx_topk.ops import approx_topk_op
from ..kernels.approx_topk.quant import QuantizedRanc
from . import cur, prng

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
            item_embeddings=move(self.item_embeddings), item_tokens=move(self.item_tokens))

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
        return dataclasses.replace(self, item_tokens=_pad_axis(tok, 0, self.capacity, 0))

    def with_capacity(self, capacity: int) -> "AnchorIndex":
        """Re-pad the item axis to ``capacity`` (at least ``n_valid``).  A
        coded payload changes only in its padded tail: every tile over the
        valid prefix keeps its codes and scale byte for byte."""
        n = self.n_items
        if capacity < n:
            raise ValueError(f"capacity={capacity} < n_valid={n}")
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
        if np.intersect1d(new_host, self.item_ids[:n0].cpu().numpy()).size:
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
            tok = tok.clone()
            tok[n0:n0 + n_new] = new_tokens
        elif new_tokens is not None:
            raise ValueError("new_tokens given but the index carries no token table; "
                             "attach one first (with_item_tokens)")
        if isinstance(self.r_anc, QuantizedRanc):
            r_anc = quant.update_columns(self.r_anc, cols, n0)   # only the touched tiles
        else:
            r_anc = self.r_anc.clone()
            r_anc[:, n0:n0 + n_new] = cols.to(r_anc.dtype)
        item_ids = self.item_ids.clone()
        item_ids[n0:n0 + n_new] = new_ids
        emb = self.item_embeddings
        if emb is not None:
            emb = emb.clone()
            emb[:, n0:n0 + n_new] = (self.u @ cols).to(emb.dtype)
        return dataclasses.replace(
            self, r_anc=r_anc, item_ids=item_ids,
            n_valid=torch.tensor(n0 + n_new, dtype=torch.int32, device=self.device),
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
        then ``index_meta.json``, written as the reference writes them."""
        tree = self._tree()
        Checkpointer(path).save(_CKPT_STEP, tree, {k: _LEAF_SPECS[k] for k in tree})
        coded = isinstance(self.r_anc, QuantizedRanc)
        # the lowest version whose on-disk features this index uses
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
    def load(cls, path: str, device=None) -> "AnchorIndex":
        """Load a saved index (format v1–v4, written by the port or the
        reference) onto ``device`` (the card unless ``device="cpu"``).  Specs
        are read and not acted on: the port has no sharded load yet."""
        meta_path = os.path.join(path, _META_FILE)
        if not os.path.exists(meta_path):
            raise FileNotFoundError(f"no AnchorIndex at {path!r} ({_META_FILE} missing)")
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("format_version") not in _READABLE_FORMAT_VERSIONS:
            raise ValueError(
                f"unsupported AnchorIndex format version {meta.get('format_version')} "
                f"(this build reads versions {_READABLE_FORMAT_VERSIONS})")
        tree = Checkpointer(path).restore(_CKPT_STEP, device=device)
        if "r_codes" in tree:
            payload = meta.get("payload") or {}
            # v2/v3 meta predates sub-int8 codes: default to the int8 layout
            tree["r_anc"] = QuantizedRanc(
                codes=tree.pop("r_codes"), scales=tree.pop("r_scales"),
                tile=int(payload.get("tile") or quant.DEFAULT_TILE),
                code_dtype=str(payload.get("code_dtype") or "int8"),
                n_cols=int(payload.get("n_cols", -1)))
        return cls(**tree)

    def engine_search(self, score_fn, query, cfg, key=None, **kw):
        """One full multi-round search over this index (single device); for
        repeated queries hold an ``AdaCURRetriever.from_index`` instead."""
        from .engine import AdaCURRetriever

        return AdaCURRetriever.from_index(self, score_fn, cfg).search(query, key, **kw)

    def topk(self, e_q: torch.Tensor, k: int, tile: int = 512):
        """Top-k of ``e_q @ R_anc`` over the valid items -> (values, positions),
        through the fused op (the CUDA kernel on the card).  The padded tail
        is suppressed by the ``n_valid`` bound, the same items as the
        reference's broadcast valid mask, without a (B, capacity) mask."""
        n_valid = self.n_items if self.n_items < self.capacity else None
        return approx_topk_op(e_q, self.r_anc, None, k, tile=tile, n_valid=n_valid)
