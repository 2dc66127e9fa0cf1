"""Cross-encoder scorers with measured CE-call accounting — port of
``repro/core/scorer.py`` (``ScorerStats``, ``SyntheticScorer``,
``TabulatedScorer``, ``CrossEncoderScorer``, ``DeviceCEScorer``,
``CachingScorer``).

The port runs eagerly, so every scorer counts ``ce_calls`` as the calls
happen (the reference's pure-traced ``SyntheticScorer`` cannot).
``record_pairs=True`` keeps a log of every scored (query ids, item ids)
batch, from which a test reconstructs each search's scored-pair multiset.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..distributed.collectives import ShardCtx, _all_gather, _local_ctx, _owned, _psum_items


@dataclass
class ScorerStats:
    requests: int = 0        # score() invocations
    pairs: int = 0           # (query, item) pairs requested
    ce_calls: int = 0        # pairs scored by the underlying model
    cache_hits: int = 0
    cache_size: int = 0
    batch_pad: int = 0

    def copy(self) -> "ScorerStats":
        return dataclasses.replace(self)

    def __sub__(self, other: "ScorerStats") -> "ScorerStats":
        return ScorerStats(
            requests=self.requests - other.requests,
            pairs=self.pairs - other.pairs,
            ce_calls=self.ce_calls - other.ce_calls,
            cache_hits=self.cache_hits - other.cache_hits,
            cache_size=self.cache_size,
            batch_pad=self.batch_pad - other.batch_pad,
        )


def scorer_stats(score_fn) -> Optional[ScorerStats]:
    """The live stats of a ScoreFn if it is a Scorer, else None."""
    s = getattr(score_fn, "stats", None)
    return s if isinstance(s, ScorerStats) else None


class _CountingScorer:
    def __init__(self, record_pairs: bool = False):
        self.stats = ScorerStats()
        self.record_pairs = record_pairs
        self.call_log: List[Tuple[np.ndarray, np.ndarray]] = []

    def reset_stats(self) -> None:
        self.stats = ScorerStats()
        self.call_log = []

    def _log(self, query, item_idx) -> None:
        """Count one request of ``item_idx.numel()`` pairs (and record it)."""
        self.stats.requests += 1
        self.stats.pairs += int(item_idx.numel())
        if self.record_pairs:
            self.call_log.append((query.detach().cpu().numpy().copy(),
                                  item_idx.detach().cpu().numpy().copy()))

    def _count(self, query, item_idx) -> None:
        """``_log`` for a scorer that scores every requested pair."""
        self._log(query, item_idx)
        self.stats.ce_calls += int(item_idx.numel())


class SyntheticScorer(_CountingScorer):
    """The closed-form synthetic CE, scored on the domain's device."""

    def __init__(self, ce, record_pairs: bool = False):
        super().__init__(record_pairs)
        self.ce = ce

    def __call__(self, query, item_idx) -> torch.Tensor:
        self._count(query, item_idx)
        return self.ce.score_pairs(query, item_idx)


class TabulatedScorer(_CountingScorer):
    """Exact-matrix lookup ``score(q, i) = matrix[q, i]``.  A tensor stays
    where it is (several scorers may share one card-resident table); an
    array is copied to a CPU tensor and moves to the ids' device at the
    first call."""

    def __init__(self, matrix, record_pairs: bool = False):
        super().__init__(record_pairs)
        if isinstance(matrix, torch.Tensor):
            self.matrix = matrix.to(torch.float32)
        else:
            self.matrix = torch.from_numpy(np.array(matrix, dtype=np.float32))

    def __call__(self, query, item_idx) -> torch.Tensor:
        self._count(query, item_idx)
        if self.matrix.device != item_idx.device:
            self.matrix = self.matrix.to(item_idx.device)
        return self.matrix[query.long()[:, None], item_idx.long()]


def bucket_for(length: int, len_buckets: Tuple[int, ...], what: str = "pair") -> int:
    """Smallest bucket >= length; a pair that fits no bucket raises a plain
    ``ValueError`` where it was caused."""
    for b in len_buckets:
        if b >= length:
            return b
    raise ValueError(
        f"{what} length {length} exceeds the largest length bucket "
        f"{max(len_buckets)} (len_buckets={tuple(len_buckets)}); extend "
        f"len_buckets to cover it, or shorten the query/item token budget "
        f"so tokenized pairs fit an existing bucket"
    )


class CrossEncoderScorer(_CountingScorer):
    """The transformer CE on the engine's hot path.

    ``pair_fn(query_ids (B,), item_idx (B, k)) -> (B, k, L)`` int32 pair
    tokens (numpy, valid first, trailing ``pad_id``).  Pairs are flattened,
    padded to the smallest length bucket and scored in whole
    ``micro_batch``-row chunks, so the model sees only a few static shapes;
    pad rows are scored but never counted in ``ce_calls`` (they count in
    ``batch_pad``).  The forward runs on the params' device: on the card
    its attention is the flash-attention CUDA kernel
    (``attn_impl='flash'``).

    ``n_traces`` is the number of distinct (micro_batch, bucket) shapes run
    so far; ``forwards`` counts model forwards since the last
    ``reset_stats``.  ``flash_block`` shapes the CPU plain version's tiles
    only, and ``flash_interpret`` has no effect (both kept so one kwargs
    dict builds both packages' scorers).  At construction ``pair_fn`` is
    probed with a one-pair dummy call, so a pair that overflows the largest
    bucket raises at once.
    """

    def __init__(self, params, cfg, pair_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
                 pad_id: int = 0, micro_batch: int = 64,
                 len_buckets: Tuple[int, ...] = (32, 64, 128, 256, 512),
                 attn_impl: str = "flash", flash_block: Tuple[int, int] = (128, 128),
                 flash_interpret: bool = True, record_pairs: bool = False):
        super().__init__(record_pairs)
        self.params = params
        self.cfg = cfg
        self.pair_fn = pair_fn
        self.pad_id = pad_id
        self.micro_batch = micro_batch
        self.len_buckets = tuple(sorted(len_buckets))
        self.attn_impl = attn_impl
        self.flash_block = flash_block
        self.flash_interpret = flash_interpret
        self.device = params["embed"].device
        self.forwards = 0
        self._shapes: set = set()
        probe = np.asarray(pair_fn(np.zeros(1, np.int64), np.zeros((1, 1), np.int64)))
        bucket_for(int(probe.shape[-1]), self.len_buckets)

    @property
    def n_traces(self) -> int:
        """Distinct (micro_batch, bucket) shapes run so far."""
        return len(self._shapes)

    def reset_stats(self) -> None:
        super().reset_stats()
        self.forwards = 0

    def _forward(self, flat: np.ndarray) -> torch.Tensor:
        """Scores (M,) fp32 on the model's device of (M, bucket) tokens, M a
        whole number of micro-batches."""
        from ..models import cross_encoder

        tokens = torch.from_numpy(flat).to(self.device)
        out = torch.empty(flat.shape[0], dtype=torch.float32, device=self.device)
        mb = self.micro_batch
        for lo in range(0, flat.shape[0], mb):
            out[lo:lo + mb] = cross_encoder.score_tokens(
                self.params, tokens[lo:lo + mb], self.cfg, pad_id=self.pad_id,
                attn_impl=self.attn_impl, flash_block=self.flash_block,
                flash_interpret=self.flash_interpret)
            self.forwards += 1
            self._shapes.add((mb, flat.shape[1]))
        return out

    def _host(self, qids: np.ndarray, idx: np.ndarray) -> torch.Tensor:
        """(B, k) scores on the model's device; counts ce_calls/batch_pad."""
        b, k = idx.shape
        tokens = np.asarray(self.pair_fn(qids, idx), dtype=np.int32)
        n, length = b * k, tokens.shape[-1]
        bucket = bucket_for(length, self.len_buckets)
        n_pad = -n % self.micro_batch
        flat = np.full((n + n_pad, bucket), self.pad_id, dtype=np.int32)
        flat[:n, :length] = tokens.reshape(n, length)
        self.stats.ce_calls += n
        self.stats.batch_pad += n_pad
        return self._forward(flat)[:n].reshape(b, k)

    def __call__(self, query, item_idx) -> torch.Tensor:
        self._log(query, item_idx)
        scores = self._host(query.detach().cpu().numpy(), item_idx.detach().cpu().numpy())
        return scores.to(item_idx.device)

    def score_block(self, query_ids, item_ids) -> torch.Tensor:
        """Bulk scores (Q, N) of (Q,) query ids x (N,) item ids, on the
        model's device — the offline index build's ``bulk_score_fn``.  Its
        pairs count in ``ce_calls``; callers reset the stats after."""
        q = query_ids.detach().cpu().numpy()
        items = item_ids.detach().cpu().numpy()
        return self._host(q, np.tile(items, (len(q), 1)))


class DeviceCEScorer(_CountingScorer):
    """The real transformer CE as a device-resident stage of the engine.

    Where :class:`CrossEncoderScorer` builds pair tokens on the host from
    query and item ids, this scorer keeps the corpus token table on the
    device, assembles ``[CLS] q [SEP] i [SEP]`` pair rows there from engine
    positions and runs the CE forward (the flash kernel on the card) inside
    the engine (``engine._device_ce_score``).  Under the sharded engine the
    flattened pair batch is split over the item shards, so every pair is
    scored once across the mesh.

    The engine's query operand is the (B, query_len) int32 token batch of
    :meth:`tokenize_queries` (host side, once per request batch).  The
    corpus table is the scorer's (``item_tokens=``) or, on the serving path,
    the index's (``AnchorIndex.with_item_tokens``), position-aligned with
    the payload through every mutation.

    Accounting is measured: :meth:`count` records each scoring round that
    ran, so ``stats.ce_calls`` equals ``engine.ce_call_plan`` x the rows,
    with the item-shard pad rows counted apart (``batch_pad``).
    ``n_traces`` is the number of distinct (rows, bucket) forward shapes
    run so far."""

    device_resident = True

    def __init__(self, params, cfg, query_token_fn: Callable[[np.ndarray], np.ndarray],
                 item_tokens=None, pad_id: int = 0, cls_id: int = 1, sep_id: int = 2,
                 len_buckets: Tuple[int, ...] = (32, 64, 128, 256, 512),
                 attn_impl: str = "flash", flash_block: Tuple[int, int] = (128, 128),
                 flash_interpret: bool = True, record_pairs: bool = False):
        super().__init__(record_pairs)
        self.params = params
        self.cfg = cfg
        self.query_token_fn = query_token_fn
        self.device = params["embed"].device
        self.item_tokens = (None if item_tokens is None else
                            torch.as_tensor(np.asarray(item_tokens)).to(self.device, torch.int32))
        self.pad_id, self.cls_id, self.sep_id = pad_id, cls_id, sep_id
        self.len_buckets = tuple(sorted(len_buckets))
        self.attn_impl = attn_impl
        self.flash_block = flash_block
        self.flash_interpret = flash_interpret
        self._shapes: set = set()

    @property
    def n_traces(self) -> int:
        return len(self._shapes)

    def tokenize_queries(self, query) -> torch.Tensor:
        """Query ids (B,) -> (B, query_len) int32 token rows on the model's
        device.  With a scorer-carried table the pair length is checked
        here against the buckets; with the index's, at :meth:`build_pairs`."""
        qids = np.asarray(query.detach().cpu().numpy() if isinstance(query, torch.Tensor)
                          else query)
        toks = np.asarray(self.query_token_fn(qids), dtype=np.int32)
        if toks.ndim != 2 or toks.shape[0] != qids.shape[0]:
            raise ValueError(f"query_token_fn must map (B,) ids to (B, query_len) tokens; "
                             f"got {toks.shape} for B={qids.shape[0]}")
        if self.item_tokens is not None:
            bucket_for(toks.shape[1] + int(self.item_tokens.shape[1]) + 3, self.len_buckets)
        return torch.from_numpy(toks).to(self.device)

    def build_pairs(self, q_tokens, item_rows) -> torch.Tensor:
        """(B, Lq) x (B, k, Li) -> (B, k, bucket) padded pair token rows."""
        from ..models import cross_encoder

        lq, li = int(q_tokens.shape[-1]), int(item_rows.shape[-1])
        return cross_encoder.build_pair_tokens(
            q_tokens, item_rows, pad_to=bucket_for(lq + li + 3, self.len_buckets),
            cls_id=self.cls_id, sep_id=self.sep_id, pad_id=self.pad_id)

    def forward(self, flat_tokens) -> torch.Tensor:
        """(M, bucket) pair rows -> (M,) fp32 CE scores on the model's device."""
        from ..models import cross_encoder

        self._shapes.add(tuple(flat_tokens.shape))
        return cross_encoder.score_tokens(
            self.params, flat_tokens.to(self.device), self.cfg, pad_id=self.pad_id,
            attn_impl=self.attn_impl, flash_block=self.flash_block,
            flash_interpret=self.flash_interpret)

    def count(self, item_idx, n_pad: int) -> None:
        """Record one scoring round of ``item_idx`` (B, k) pairs; ``n_pad``
        pad rows were scored beside them and are not CE calls."""
        self.stats.requests += 1
        self.stats.pairs += int(item_idx.numel())
        self.stats.ce_calls += int(item_idx.numel())
        self.stats.batch_pad += int(n_pad)
        if self.record_pairs:
            self.call_log.append((None, item_idx.detach().cpu().numpy().copy()))

    def __call__(self, query_tokens, item_idx) -> torch.Tensor:
        """A plain ScoreFn over the scorer-carried table (one device)."""
        if self.item_tokens is None:
            raise ValueError("DeviceCEScorer needs a corpus token table to score directly: "
                             "construct it with item_tokens=, or search through an index "
                             "that carries one (AnchorIndex.with_item_tokens)")
        return _device_ce_score(_local_ctx(int(self.item_tokens.shape[0])), self,
                                query_tokens, item_idx, self.item_tokens)


def _gather_token_rows(ctx: ShardCtx, table, gidx):
    """Corpus token rows of GLOBAL item positions -> (..., Li) int32: each
    item shard gathers the rows it owns, zeros elsewhere, one sum."""
    if ctx.item_group is None:
        return table[gidx.long()]
    local, owned = _owned(ctx, gidx)
    return _psum_items(ctx, torch.where(owned[..., None], table[local], 0))


def _device_ce_score(ctx: ShardCtx, scorer: DeviceCEScorer, q_tokens, gidx, item_tokens):
    """Device-resident CE scores of a (B, k) position batch: gather the
    items' token rows, assemble ``[CLS] q [SEP] i [SEP]`` pairs and run the
    CE forward (the flash kernel on the card).  Under the mesh the
    flattened pair batch is split over the item shards (each scores an
    equal contiguous chunk, ``all_gather`` reassembles), so every pair is
    scored once across the mesh; item shard 0 counts the batch, with the
    item-shard pad rows excluded."""
    rows = _gather_token_rows(ctx, item_tokens, gidx)           # (B, k, Li)
    pairs = scorer.build_pairs(q_tokens, rows)                  # (B, k, Lb)
    b, k, lb = pairs.shape
    n = b * k
    flat = pairs.reshape(n, lb)
    if ctx.item_group is None:
        scores = scorer.forward(flat)
        scorer.count(gidx, 0)
    else:
        n_pad = -n % ctx.n_item_shards
        if n_pad:
            flat = torch.cat([flat, torch.full((n_pad, lb), scorer.pad_id, dtype=flat.dtype,
                                               device=flat.device)])
        chunk = (n + n_pad) // ctx.n_item_shards
        local = flat[ctx.item_shard * chunk:(ctx.item_shard + 1) * chunk]
        s = scorer.forward(local).to(torch.float32)
        scores = _all_gather(ctx.item_group, s, 0)[:n]
        if ctx.item_shard == 0:
            scorer.count(gidx, n_pad)
    return scores.reshape(b, k).to(torch.float32)


class CachingScorer(_CountingScorer):
    """(query_id, item_id) score cache over another port scorer.

    Repeat queries hit the cache and skip the inner model; within one call
    duplicate pairs are scored once and count as neither a hit nor a CE
    call.  ``stats.ce_calls`` counts only the inner model's misses;
    ``capacity`` bounds residency with LRU eviction.  Keys are the ids the
    engine passes (external ids through ``AnchorIndex.item_ids``).
    """

    def __init__(self, inner: _CountingScorer, capacity: int = 1_000_000,
                 record_pairs: bool = False):
        super().__init__(record_pairs)
        if not isinstance(inner, _CountingScorer):
            raise TypeError("CachingScorer wraps a port scorer (TabulatedScorer, "
                            f"CrossEncoderScorer, ...), got {type(inner).__name__}")
        self.inner = inner
        self.capacity = capacity
        self._cache: "OrderedDict[int, float]" = OrderedDict()

    def reset_stats(self, clear_cache: bool = False) -> None:
        super().reset_stats()
        self.inner.reset_stats()
        if clear_cache:
            self._cache.clear()

    def __call__(self, query, item_idx) -> torch.Tensor:
        self._log(query, item_idx)
        qids = query.detach().cpu().numpy().astype(np.int64)
        idx = item_idx.detach().cpu().numpy().astype(np.int64)
        b, k = idx.shape
        flat_keys = ((qids[:, None] << 32) | idx).reshape(-1)
        out = np.empty(b * k, dtype=np.float32)
        miss_keys: List[int] = []
        miss_pos: dict = {}          # key -> every flat position needing it
        for pos, key in enumerate(flat_keys.tolist()):
            hit = self._cache.get(key)
            if hit is not None:
                out[pos] = hit
                self._cache.move_to_end(key)
                self.stats.cache_hits += 1
            elif key in miss_pos:
                miss_pos[key].append(pos)
            else:
                miss_pos[key] = [pos]
                miss_keys.append(key)
        if miss_keys:
            mk = np.asarray(miss_keys, dtype=np.int64)
            q_m = torch.from_numpy(mk >> 32).to(query.device)
            i_m = torch.from_numpy(mk & 0xFFFFFFFF).to(item_idx.device)
            scores = self.inner(q_m, i_m[:, None]).detach().cpu().numpy().reshape(-1)
            self.stats.ce_calls += len(miss_keys)
            for key, s in zip(miss_keys, scores.tolist()):
                self._cache[key] = s
                if len(self._cache) > self.capacity:
                    self._cache.popitem(last=False)
                for pos in miss_pos[key]:
                    out[pos] = s
        self.stats.cache_size = len(self._cache)
        return torch.from_numpy(out.reshape(b, k)).to(item_idx.device)
