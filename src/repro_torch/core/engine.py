"""Static-shape multi-round ADACUR engine — port of ``repro/core/engine.py``
(``engine_search``, ``make_sharded_engine`` and the retrievers).

The search runs eagerly in PyTorch over preallocated slabs: the anchor-id
(B, k_i), exact-score (B, k_i), anchor-column (B, k_q, k_i) and
incremental-pinv (B, k_i, k_q) buffers are allocated at their final size and
round r fills slab ``[r·k_s, (r+1)·k_s)``; unfilled entries are exact zeros.
Loop modes: ``unrolled`` (the full ``cfg.n_rounds``), ``fori`` (a runtime
``n_rounds`` ≤ ``cfg.n_rounds``), the early-exit monitor, and — with
``round_kernel="persistent"`` — the software-pipelined monitored loop in
which round r+1's sample and round r's monitor share one payload sweep.

With ``use_fused_topk`` every item-axis pass (round sampling, the early-exit
monitor, rerank candidate selection) goes through ``approx_topk_op`` or
``persistent_round_op``: the hand-written CUDA kernels for CUDA tensors,
their plain versions for CPU tensors.  No (B, N) score matrix is formed on
that path; round 0's random draw reads the (B, N) Gumbel field, as in the
reference.  Every top-k is index-stable.

Every method is a configuration of this one engine behind the
:class:`Retriever` protocol: :class:`AdaCURRetriever` (the paper),
:class:`ANNCURRetriever` (fixed anchors, one retriever-seeded round) and
:class:`RerankRetriever` (retrieve-and-rerank, one retriever-seeded round
with no budget split).  A per-query ``eligible`` mask restricts a search to
a candidate set (hybrid retrieval), ``pos_map`` declares the payload a
candidate subset gathered from those corpus positions (every noise draw
then reads the canonical field there, so the subset search equals the
masked full-corpus one bit for bit), and an :class:`AnytimeDeadline` cuts
the round loop at a wall-clock deadline.

The sharded engine (:func:`make_sharded_engine`) runs the same search over a
(data x items) ``torch.distributed`` mesh, one process per rank: the item
axis of the payload is split into per-rank slabs, the query batch into
per-rank rows, and the collective layer (``distributed/collectives.py``:
:class:`ShardCtx` and the cross-shard primitives, with the engine's own
below) is where a global item id meets a rank's slab.  Its results are
bitwise those of the single-device engine.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import AdaCURConfig, replace
from ..distributed import sharding
from ..distributed.collectives import (ShardCtx, _axes_index, _dims_group, _gather_rows,
                                       _item_offset, _local_ctx, _local_topk_merge,
                                       _map_item_ids, _merge_topk, _owned, _psum_items,
                                       collective_calls)
from ..kernels.approx_topk import quant
from ..kernels.approx_topk.ops import approx_topk_op
from ..kernels.approx_topk.persistent import persistent_round_op
from ..kernels.approx_topk.select import NEG_INF, stable_topk
from . import cur, prng, sampling
from .adacur import AdaCURResult, ScoreFn, query_batch
from .scorer import _device_ce_score


def ce_call_plan(cfg: AdaCURConfig, rounds: Optional[int] = None) -> int:
    """Exact CE calls per query for a run executing ``rounds`` rounds."""
    k_i = cfg.budget_ce if not cfg.split_budget else cfg.k_anchor
    k_s = k_i // cfg.n_rounds
    r = cfg.n_rounds if rounds is None else rounds
    if not 1 <= r <= cfg.n_rounds:
        raise ValueError(f"rounds={r} outside [1, {cfg.n_rounds}]")
    k_r = cfg.budget_ce - k_i if cfg.split_budget else 0
    return k_s * r + k_r


class AnytimeDeadline:
    """Wall-clock deadline the engine's round loop polls at every round
    boundary (the anytime-serving contract of the reference's
    ``AnytimeDeadline``): every round boundary is a valid, coarser answer,
    so a search past its deadline returns the provisional top-k of the
    rounds it completed.  Round 0 always runs, and the split-budget rerank
    still spends its ``budget_ce - k_anchor`` calls.

    The port's round loop runs on the host, ahead of the card: a poll must
    see rounds that have executed, not rounds that were enqueued, or
    ``rounds_done`` would report enqueue progress and a cut round's CE calls
    (the scorer counts them as they are issued) would already be spent.  So
    :meth:`expired` first waits for the device's stream (a synchronize),
    then reads the clock.  That costs one sync per round, which is why the
    deadline is opt-in (``make_engine(anytime=True)``).

    ``fired`` records whether the deadline cut the loop short: the loop
    polls only before a round it would otherwise run, so a search that
    finishes all its rounds is never marked.  ``arm()`` resets it,
    ``disarm()`` leaves it readable."""

    def __init__(self):
        self.deadline_t = float("inf")
        self.fired = False

    def arm(self, deadline_t: float) -> None:
        self.deadline_t = float(deadline_t)
        self.fired = False

    def disarm(self) -> None:
        """Stop cutting rounds; ``fired`` stays readable for the caller."""
        self.deadline_t = float("inf")

    def expired(self, device) -> bool:
        """True (and ``fired``) once the clock passes the deadline, read
        after the rounds enqueued on ``device`` have run."""
        if self.deadline_t == float("inf"):
            return False
        if torch.device(device).type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        if time.monotonic() >= self.deadline_t:
            self.fired = True
        return self.fired


class EngineState(NamedTuple):
    anchor_idx: torch.Tensor   # (B, k_i) int32, -1 in unfilled slots
    c_test: torch.Tensor       # (B, k_i) exact CE scores, 0 unfilled
    a_buf: torch.Tensor        # (B, k_q, k_i) anchor columns, 0 unfilled
    p: torch.Tensor            # (B, k_i, k_q) incremental pinv, 0 unfilled
    e_q: torch.Tensor          # (B, k_q) latent query embedding
    selected: torch.Tensor     # (B, N) bool mask of already-selected items


# ---------------------------------------------------------------------------
# The engine's side of the collective layer (``distributed/collectives.py``
# holds ShardCtx and the cross-shard primitives): the per-shard noise, the
# selected mask, the anchor-column gather, score-once and the early-exit
# fraction.  On a trivial context every helper is the plain local math.
# ---------------------------------------------------------------------------


def _noise(ctx: ShardCtx, key, rows: int, device) -> torch.Tensor:
    """This context's (rows, N_local) rectangle of the canonical noise
    field, or, for a candidate subset (``col_map``: each column's corpus
    position), the field at those positions (:func:`sampling.gumbel_at`):
    the draws a masked full-corpus search sees at the same columns."""
    if ctx.col_map is not None:
        return sampling.gumbel_at(key, rows, ctx.col_map, ctx.row_offset)
    return sampling.blocked_gumbel(key, rows, ctx.n_local, ctx.row_offset,
                                   _item_offset(ctx), device=device)


def _sample_random_ctx(ctx: ShardCtx, key, selected, k: int):
    """Uniform w/o replacement over unselected items (global ids): the
    masked-Gumbel formula of ``sampling.sample_random`` over this shard's
    rectangle of the noise field."""
    b, _ = selected.shape
    logits = torch.where(selected, NEG_INF, 0.0).to(torch.float32)
    return _local_topk_merge(ctx, logits + _noise(ctx, key, b, selected.device), k)


def _mark_selected(ctx: ShardCtx, selected, gidx):
    """Set each row's (global-id) picks in the local selected mask; ids
    owned by other shards drop (a guarded scatter into a spare column that
    is then cut off)."""
    b, n = selected.shape
    g = gidx.long() - _item_offset(ctx)
    g = torch.where((g >= 0) & (g < n), g, n)
    pad = torch.zeros((b, 1), dtype=torch.bool, device=selected.device)
    return torch.cat([selected, pad], 1).scatter_(1, g, True)[:, :n].contiguous()


def _gather_cols(ctx: ShardCtx, r_anc, gidx) -> torch.Tensor:
    """R_anc[:, gidx] -> (B, k_q, k) fp32: each shard dequantizes the
    columns it owns, zeros elsewhere, one sum over the item group."""
    if ctx.item_group is None:
        return quant.gather_columns(r_anc, gidx)
    local, owned = _owned(ctx, gidx)
    cols = quant.gather_columns(r_anc, local)
    return _psum_items(ctx, torch.where(owned[:, None, :], cols, 0.0))


def _score_once(ctx: ShardCtx, score_fn: ScoreFn, query, ids):
    """Exact-CE scores of a (B, k) id batch, computed EXACTLY ONCE across
    the mesh: item shard 0 of each data shard calls the scorer and
    broadcasts the fp32 scores to its item group, so a counting scorer's
    calls, summed over the ranks, equal the plan.  The bits are those of
    the reference's sum with zeros."""
    if ctx.item_group is None:
        return score_fn(query, ids)
    if ctx.item_shard == 0:
        c = score_fn(query, ids).to(torch.float32).contiguous()
    else:
        c = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    dist.broadcast(c, src=dist.get_global_rank(ctx.item_group, 0), group=ctx.item_group)
    collective_calls.add()
    return c


def _global_frac(ctx: ShardCtx, hit) -> float:
    """Batch-mean of a boolean (B_local, m) statistic over the GLOBAL batch
    (the early-exit monitor must stop every shard on the same round): the
    hit count, summed over the data group, over the global entry count, in
    fp32, so the sharded mean is bit-equal to the single-device one."""
    count = hit.sum().to(torch.int64).reshape(1)
    if ctx.data_group is not None:
        dist.all_reduce(count, group=ctx.data_group)
        collective_calls.add()
    n = hit.numel() * ctx.n_data_shards
    return float(np.float32(int(count.item())) / np.float32(n))


def _effective_tile(cfg: AdaCURConfig, r_anc) -> int:
    """Item tile of the plain version: ``cfg.fused_tile`` is a per-tile
    byte budget in fp32 columns, widened by fp32's bytes over a payload
    column's so each tile holds the same bytes (the reference's
    ``_effective_tile`` for its CPU scan backend, engine.py:403-425).  The
    CUDA kernels pick their own tiling."""
    return cfg.fused_tile * int(4 / quant.BYTES_PER_COL[quant.payload_dtype_of(r_anc)])


def _fused_suppress(state: EngineState, force_mask: bool = False) -> dict:
    """How the fused op suppresses already-selected items: the (B, k_i)
    anchor-id list while the valid-item bound is static, the (B, N)
    ``selected`` mask when it is a runtime value (the id list cannot see an
    invalid padded tail) — the reference's card path (``engine.py:428``)."""
    if force_mask:
        return dict(anchors=None, mask=state.selected)
    return dict(anchors=state.anchor_idx, mask=None)


def _bcast_mask(invalid, b: int, n: int):
    if invalid is None:
        return None
    inv = invalid if invalid.dim() == 2 else invalid[None, :]
    return inv.expand(b, n).contiguous()


def _provisional_topk(cfg, e_q, r_anc, m: int, n_valid, invalid=None,
                      ctx: Optional[ShardCtx] = None):
    """Top-m ids of the current estimate S_hat — the early-exit monitor.
    ``invalid`` is the runtime invalid-column mask, (N_local,) or (B,
    N_local); global ids come back (merged on a sharded context)."""
    n = r_anc.shape[1]
    ctx = ctx or _local_ctx(n)
    sharded = ctx.item_group is not None
    if cfg.use_fused_topk:
        v, idx = approx_topk_op(
            e_q, r_anc, None, m, tile=_effective_tile(cfg, r_anc),
            n_valid=None if sharded else n_valid,
            mask=_bcast_mask(invalid, e_q.shape[0], n),
        )
        return _merge_topk(ctx, v, idx + _item_offset(ctx), m)[1] if sharded else idx
    s_hat = quant.matmul(e_q, r_anc)
    if n_valid is not None and not sharded and n_valid < n:
        s_hat = torch.where(torch.arange(n, device=s_hat.device) < n_valid, s_hat, NEG_INF)
    if invalid is not None:
        s_hat = torch.where(invalid, NEG_INF, s_hat)
    return _local_topk_merge(ctx, s_hat, m)


def _sample_round(cfg, key, state: EngineState, r_anc, k_eff: int, n_valid,
                  ctx: ShardCtx, force_mask: bool = False, monitor=None):
    """One adaptive round's anchor pick (Alg. 3), dense or fused, over this
    shard's payload slab -> GLOBAL ids; ``monitor=(m, invalid)`` also
    returns the provisional top-m of the current estimate — from the same
    persistent sweep where the sample and provisional branches share the
    estimate GEMM.  A sharded context always suppresses by the (B, N_local)
    mask (its validity is a runtime bound), draws its noise at its column
    offset and merges each list over the item shards."""
    b, n = state.selected.shape
    sharded = ctx.item_group is not None
    off = _item_offset(ctx)

    def with_monitor(gidx):
        if monitor is None:
            return gidx
        m, invalid = monitor
        return gidx, _provisional_topk(cfg, state.e_q, r_anc, m, n_valid, invalid, ctx)

    def merged(v, idx, k):
        return _merge_topk(ctx, v, idx + off, k)[1] if sharded else idx

    if cfg.strategy == "random":
        return with_monitor(_sample_random_ctx(ctx, key, state.selected, k_eff))
    if not cfg.use_fused_topk:
        # sampling.sample_topk / sample_softmax over this shard's columns
        logits = sampling._masked_logits(quant.matmul(state.e_q, r_anc), state.selected,
                                         cfg.softmax_temp)
        if cfg.strategy == "softmax":
            logits = logits + _noise(ctx, key, b, logits.device)
        return with_monitor(_local_topk_merge(ctx, logits, k_eff))
    suppress = _fused_suppress(state, force_mask or sharded)
    tile = _effective_tile(cfg, r_anc)
    nv = None if sharded else n_valid
    e_q = state.e_q
    if cfg.strategy == "softmax":
        # temp folds into e_q: scores/temp == (e_q/temp) @ R_anc
        e_q = e_q / torch.tensor(cfg.softmax_temp, dtype=e_q.dtype)
    if cfg.round_kernel == "persistent":
        kw = dict(k_sample=k_eff, tile=tile, n_valid=nv, **suppress)
        if cfg.strategy == "softmax" and ctx.col_map is not None:
            kw["noise"] = _noise(ctx, key, b, e_q.device)
        elif cfg.strategy == "softmax":
            kw.update(noise_key=key, row_offset=ctx.row_offset, col_offset=off)
        if monitor is not None and (cfg.strategy == "topk" or cfg.softmax_temp == 1.0):
            m, invalid = monitor
            (v, idx), (pv, pidx) = persistent_round_op(
                e_q, r_anc, k_prov=m, prov_mask=_bcast_mask(invalid, b, n), **kw
            )
            return merged(v, idx, k_eff), merged(pv, pidx, m)
        (v, idx), _ = persistent_round_op(e_q, r_anc, **kw)
        return with_monitor(merged(v, idx, k_eff))
    noise = _noise(ctx, key, b, e_q.device) if cfg.strategy == "softmax" else None
    v, idx = approx_topk_op(e_q, r_anc, k=k_eff, tile=tile, noise=noise,
                            n_valid=nv, **suppress)
    return with_monitor(merged(v, idx, k_eff))


def _make_round_steps(scored, r_anc, query, cfg, keys, k_s: int, n_valid,
                      ctx: ShardCtx, force_mask: bool = False):
    """The round split into ``sample(r, state, monitor=None)`` (the pick)
    and ``apply(r, state, idx_new)`` (ε mix, CE scoring, slab and pinv
    updates); ``body = apply ∘ sample``.  The persistent monitored loop
    composes them pipelined — ``sample`` reads only state ``apply``
    finalized, so the values do not change, only the sweeps halve.  Every
    item id in play is global; ``scored`` scores each pair once across the
    mesh."""
    n_rand = int(round(cfg.round_epsilon * k_s))

    def sample(r, state, monitor=None):
        return _sample_round(cfg, keys[r], state, r_anc, k_s - n_rand, n_valid, ctx,
                             force_mask, monitor=monitor)

    def apply(r, state, idx_new):
        if n_rand:
            sel_tmp = _mark_selected(ctx, state.selected, idx_new)
            idx_rand = _sample_random_ctx(ctx, prng.fold_in(keys[r], 1), sel_tmp, n_rand)
            idx_new = torch.cat([idx_new, idx_rand], dim=1)
        idx_new = idx_new.to(torch.int32)
        selected = _mark_selected(ctx, state.selected, idx_new)
        start = r * k_s
        c_new = scored(query, idx_new)
        cols_new = _gather_cols(ctx, r_anc, idx_new)
        anchor_idx = state.anchor_idx.clone()
        anchor_idx[:, start:start + k_s] = idx_new
        c_test = state.c_test.clone()
        c_test[:, start:start + k_s] = c_new
        a_buf = state.a_buf.clone()
        a_buf[:, :, start:start + k_s] = cols_new
        if cfg.incremental_pinv:
            p = _bordered(state.a_buf, state.p, cols_new, start)
        else:
            p = cur.pinv(a_buf, cfg.pinv_rcond)
        return EngineState(anchor_idx, c_test, a_buf, p, _e_q(c_test, p), selected)

    def body(r, state):
        return apply(r, state, sample(r, state))

    return sample, apply, body


# the fewest rows a bordered pinv update takes on the card: for a batch of
# one or two matrices cuSOLVER takes another LU than for more, and so gives
# a row other bits, while from three rows on a row's bits do not depend on
# its batch.  ``batch_bits.py`` found it by calling the update unpadded at
# every size of 1-64 rows (k_q 500, blocks of 20 columns): only calls of 1
# and 2 rows missed the 256-row call's bits.  The first block's pinv and e_q
# missed at no size and run unpadded.  tests/test_torch_cuda.py holds the
# engine's calls of 1-64, 100, 128 and 200 rows to a 256-row batch's bits:
# what lets a data shard of any row count reproduce the single-device
# engine bit for bit.
BORDERED_MIN_ROWS = 3


def _bordered(a_full, p_full, cols_new, start: int):
    """``cur.block_pinv_extend_static`` over a batch of per-row problems; on
    the card a batch of fewer than ``BORDERED_MIN_ROWS`` rows runs padded to
    that many with copies of its last row."""
    b = a_full.shape[0]
    if b >= BORDERED_MIN_ROWS or a_full.device.type != "cuda":
        return cur.block_pinv_extend_static(a_full, p_full, cols_new, start)
    pad = torch.arange(BORDERED_MIN_ROWS, device=a_full.device).clamp(max=b - 1)
    return cur.block_pinv_extend_static(a_full[pad], p_full[pad], cols_new[pad], start)[:b]


def _e_q(c_test, p):
    """e_q = c_test @ p per row, (B, k_i) x (B, k_i, k_q) -> (B, k_q), as a
    product and a reduction over k_i: on the card its bits do not depend on
    the batch, where a batched GEMM's do (cuBLAS picks its kernel by the
    batch)."""
    return (c_test[:, :, None] * p).sum(1)


def _pad_short_ranking(top_idx, top_s):
    """Repeat the row-best candidate in slots a short run left unfilled."""
    ok = top_s > 0.5 * NEG_INF
    return (torch.where(ok, top_idx, top_idx[:, :1]),
            torch.where(ok, top_s, top_s[:, :1]))


def _hit(cur_top, prev_top):
    return (cur_top[:, :, None] == prev_top[:, None, :]).any(-1)


def engine_search(score_fn: ScoreFn, r_anc, query, cfg: AdaCURConfig, key,
                  first_anchors=None, batch: Optional[int] = None,
                  n_valid_items=None, n_rounds: Optional[int] = None,
                  return_scores: Optional[bool] = None,
                  item_ids=None, eligible=None, pos_map=None, item_tokens=None,
                  deadline: Optional[AnytimeDeadline] = None,
                  _ctx: Optional[ShardCtx] = None) -> AdaCURResult:
    """Run Algorithm 1 (+ retrieval) through the static-shape round engine.

    Runs on the payload's device.  ``query`` is any batched query pytree (a
    tensor, or a dict/list of them, e.g. DLRM's ``{"dense", "sparse"}``),
    handed to ``score_fn`` untouched; the batch size is ``first_anchors``'
    rows, else ``batch``, else the first leaf's leading dimension
    (``adacur.query_batch``, the reference's rule).
    ``n_valid_items`` as a Python int is a static bound; as a tensor it is
    a runtime bound (suppression then goes through the selected mask, as on
    the reference's dynamic path).  ``item_ids`` (N,) maps positions to
    external ids before every CE call.  ``eligible`` (B, N) or (N,) bool
    restricts each query to its True items: the rest are never sampled,
    never reranked and left out of the early-exit monitor, and the CE
    accounting does not change.  ``pos_map`` (N,) ascending int declares
    the payload's columns a candidate subset gathered from those corpus
    positions (``quant.subset_columns``): every noise draw reads the
    canonical field at the mapped coordinates, so the search equals the
    same search over the full corpus masked to the subset (``eligible``),
    and ascending order keeps the ascending-id tie-break.  Results stay in
    subset coordinates; callers map them through ``pos_map``.
    ``deadline`` (``loop_mode='fori'`` only) cuts the round loop at an
    armed :class:`AnytimeDeadline`.

    A device-resident scorer (``score_fn.device_resident``, e.g.
    :class:`~repro_torch.core.scorer.DeviceCEScorer`) scores in the engine:
    ``query`` is then the (B, Lq) query token batch and ``item_tokens`` the
    (N, Li) corpus token table (position-indexed like the payload;
    ``item_ids`` never applies), defaulting to the scorer's own table.

    ``_ctx`` is the shard context when this call is one rank's part of the
    sharded engine (:func:`make_sharded_engine`): ``r_anc``, ``item_ids``,
    ``eligible`` and ``item_tokens`` are then this rank's LOCAL slabs and
    ``query`` its batch rows, while ``n_valid_items`` stays the GLOBAL
    valid count.
    """
    r_anc = quant.as_payload(r_anc, cfg.payload_dtype, cfg.payload_tile)
    k_q, n_items = r_anc.shape
    dev = r_anc.device
    if pos_map is not None and _ctx is not None:
        raise ValueError("pos_map (candidate-subset search) is single-shard only; under "
                         "a mesh use the eligible mask over the sharded full corpus")
    col_map = None if pos_map is None else torch.as_tensor(pos_map, device=dev)
    ctx = _ctx or _local_ctx(n_items, col_map)
    sharded = ctx.item_group is not None
    n_global = n_items * ctx.n_item_shards
    k_i = cfg.budget_ce if not cfg.split_budget else cfg.k_anchor
    r_max = cfg.n_rounds
    k_s = k_i // r_max
    if return_scores is None:
        return_scores = not cfg.use_fused_topk and not sharded
    if sharded and return_scores:
        raise ValueError("return_scores is unavailable under the sharded engine: the "
                         "(B, N) approximate score matrix is exactly what sharding "
                         "refuses to materialize")
    n_valid, invalid = None, None
    if sharded:
        # always the dynamic-mask path: validity is a local column mask
        # derived from the (replicated) global bound
        nv = n_global if n_valid_items is None else n_valid_items
        nv = torch.clamp(torch.as_tensor(nv, device=dev), max=n_global)
        invalid = _item_offset(ctx) + torch.arange(n_items, device=dev) >= nv
    elif n_valid_items is not None:
        if isinstance(n_valid_items, (int, np.integer)):
            if n_valid_items < n_items:
                n_valid = int(n_valid_items)
        else:
            nv = torch.clamp(torch.as_tensor(n_valid_items, device=dev), max=n_items)
            invalid = torch.arange(n_items, device=dev) >= nv
    if eligible is not None:
        eligible = torch.as_tensor(eligible, device=dev).to(torch.bool)
        if eligible.dim() == 1:
            eligible = eligible[None, :]
    # the early-exit monitor's invalid mask: padded tail + ineligible items
    mon_invalid = invalid
    if eligible is not None:
        mon_invalid = ~eligible if invalid is None else (~eligible | invalid[None, :])
    dyn_valid = invalid is not None or eligible is not None
    if cfg.loop_mode == "unrolled" and n_rounds is not None:
        raise ValueError("runtime n_rounds override requires loop_mode='fori'")
    if deadline is not None:
        if cfg.loop_mode != "fori":
            raise ValueError("an anytime deadline needs the runtime round loop: "
                             "use loop_mode='fori'")
        if sharded:
            raise ValueError("anytime deadlines are single-device only: per-rank clocks "
                             "would disagree on the round count and deadlock the "
                             "collectives; the serving tier's unit of redundancy is the "
                             "replica, not the shard")

    b = query_batch(query, first_anchors, batch)
    if first_anchors is not None and tuple(first_anchors.shape) != (b, k_s):
        raise ValueError(f"first_anchors must be ({b}, k_s={k_s}), got "
                         f"{tuple(first_anchors.shape)}")

    # the score-once wrapper: positions -> external ids -> one CE call per
    # pair across the mesh, or, for a device-resident scorer, positions ->
    # token rows -> the CE forward, split over the item shards
    if getattr(score_fn, "device_resident", False):
        if item_tokens is None:
            item_tokens = getattr(score_fn, "item_tokens", None)
        if item_tokens is None:
            raise ValueError("a device-resident scorer needs the corpus token table: pass "
                             "item_tokens= (carried by AnchorIndex.with_item_tokens) or "
                             "construct the scorer with one")
        if item_tokens.shape[0] != n_items:
            raise ValueError(f"item_tokens rows ({item_tokens.shape[0]}) must match the "
                             f"payload's item columns ({n_items}); the token table is "
                             "position-indexed alongside r_anc")
        item_tokens = item_tokens.to(dev)

        def scored(q, gidx, _tok=item_tokens):
            return _device_ce_score(ctx, score_fn, q, gidx, _tok)
    elif sharded:
        def scored(q, gidx):
            ids = gidx if item_ids is None else _map_item_ids(ctx, item_ids, gidx)
            return _score_once(ctx, score_fn, q, ids)
    elif item_ids is not None:
        def scored(q, gidx, _f=score_fn, _ids=item_ids):
            return _f(q, _ids[gidx.long()])
    else:
        scored = score_fn

    selected = torch.zeros((b, n_items), dtype=torch.bool, device=dev)
    if n_valid is not None:
        selected |= (torch.arange(n_items, device=dev) >= n_valid)[None, :]
    if invalid is not None:
        selected |= invalid[None, :]
    if eligible is not None:
        selected |= ~eligible

    keys = prng.split(key, r_max + 1)

    # --- round 0: random or retriever-seeded first anchors ----------------
    if first_anchors is not None and cfg.first_round == "retriever":
        idx0 = first_anchors.to(device=dev, dtype=torch.int32)
    else:
        idx0 = _sample_random_ctx(ctx, keys[0], selected, k_s)
    selected = _mark_selected(ctx, selected, idx0)
    c0 = scored(query, idx0).to(torch.float32)
    cols0 = _gather_cols(ctx, r_anc, idx0)
    anchor_idx = torch.full((b, k_i), -1, dtype=torch.int32, device=dev)
    anchor_idx[:, :k_s] = idx0
    c_test = torch.zeros((b, k_i), dtype=torch.float32, device=dev)
    c_test[:, :k_s] = c0
    a_buf = torch.zeros((b, k_q, k_i), dtype=torch.float32, device=dev)
    a_buf[:, :, :k_s] = cols0
    p = torch.zeros((b, k_i, k_q), dtype=torch.float32, device=dev)
    e_q = torch.zeros((b, k_q), dtype=torch.float32, device=dev)
    if cfg.split_budget or return_scores or r_max > 1:
        init = cur.incremental_pinv_init if cfg.incremental_pinv else cur.pinv
        p[:, :k_s, :] = init(cols0, cfg.pinv_rcond)
        e_q = _e_q(c_test, p)
    state = EngineState(anchor_idx, c_test, a_buf, p, e_q, selected)

    sample_step, apply_step, body = _make_round_steps(
        scored, r_anc, query, cfg, keys, k_s, n_valid, ctx, force_mask=dyn_valid
    )

    # --- rounds 1..n_rounds-1 ---------------------------------------------
    if cfg.loop_mode == "unrolled":
        for r in range(1, r_max):
            state = body(r, state)
        rounds_done = r_max
    else:
        r_dyn = min(max(int(r_max if n_rounds is None else n_rounds), 1), r_max)
        # the reference compares a float32 overlap with a float32 bound
        stop_at = float(np.float32(1.0 - cfg.early_exit_tol))
        m = min(cfg.k_retrieve, n_global)
        monitor = (m, mon_invalid)
        r, frac = 1, 0.0

        def cut() -> bool:   # polled only before a round the loop would run
            return deadline is not None and deadline.expired(dev)

        if cfg.early_exit_tol > 0.0 and cfg.round_kernel == "persistent":
            pending, prev = sample_step(1, state, monitor=monitor)
            while r < r_dyn and frac < stop_at and not cut():
                state = apply_step(r, state, pending)
                pending, cur_top = sample_step(r + 1, state, monitor=monitor)
                frac, prev, r = _global_frac(ctx, _hit(cur_top, prev)), cur_top, r + 1
        elif cfg.early_exit_tol > 0.0:
            prev = _provisional_topk(cfg, state.e_q, r_anc, m, n_valid, mon_invalid, ctx)
            while r < r_dyn and frac < stop_at and not cut():
                state = body(r, state)
                cur_top = _provisional_topk(cfg, state.e_q, r_anc, m, n_valid, mon_invalid,
                                            ctx)
                frac, prev, r = _global_frac(ctx, _hit(cur_top, prev)), cur_top, r + 1
        else:
            while r < r_dyn and not cut():
                state = body(r, state)
                r += 1
        rounds_done = r

    anchor_idx, c_test = state.anchor_idx, state.c_test
    valid_slot = torch.arange(k_i, device=dev) < rounds_done * k_s
    anchor_logits = torch.where(valid_slot[None, :], c_test, NEG_INF)
    s_hat = quant.matmul(state.e_q, r_anc) if return_scores else None

    # --- retrieval ---------------------------------------------------------
    if not cfg.split_budget:
        top_s, top_pos = stable_topk(anchor_logits, min(cfg.k_retrieve, k_i))
        top_idx = torch.gather(anchor_idx, 1, top_pos.long())
        top_idx, top_s = _pad_short_ranking(top_idx, top_s)
        return AdaCURResult(anchor_idx, c_test, s_hat, top_idx, top_s,
                            ce_call_plan(cfg), rounds_done)

    k_r = cfg.budget_ce - k_i
    if cfg.use_fused_topk:
        v_r, rerank_idx = approx_topk_op(
            state.e_q, r_anc, k=k_r, tile=_effective_tile(cfg, r_anc),
            n_valid=None if sharded else n_valid, **_fused_suppress(state, dyn_valid),
        )
        if sharded:
            rerank_idx = _merge_topk(ctx, v_r, rerank_idx + _item_offset(ctx), k_r)[1]
    else:
        full = s_hat if s_hat is not None else quant.matmul(state.e_q, r_anc)
        rerank_idx = _local_topk_merge(ctx, torch.where(state.selected, NEG_INF, full), k_r)
    rerank_scores = scored(query, rerank_idx).to(torch.float32)
    pool_idx = torch.cat([anchor_idx, rerank_idx.to(torch.int32)], dim=1)
    pool_scores = torch.cat([anchor_logits, rerank_scores], dim=1)
    top_s, top_pos = stable_topk(pool_scores, min(cfg.k_retrieve, pool_idx.shape[1]))
    top_idx = torch.gather(pool_idx, 1, top_pos.long())
    top_idx, top_s = _pad_short_ranking(top_idx, top_s)
    return AdaCURResult(anchor_idx, c_test, s_hat, top_idx, top_s,
                        ce_call_plan(cfg), rounds_done)


def make_engine(score_fn: ScoreFn, cfg: AdaCURConfig, return_scores: Optional[bool] = None,
                anytime: bool = False) -> Callable:
    """Engine closure over a scorer + config.  In ``fori`` mode the
    callable takes a runtime ``n_rounds`` in [1, cfg.n_rounds].

    ``anytime=True`` (``fori`` only) threads an :class:`AnytimeDeadline`
    through the round loop and exposes it as ``run.deadline``: arm it with
    an absolute ``time.monotonic()`` deadline before a search, and the loop
    stops at the first round boundary past it."""
    deadline = None
    if anytime:
        if cfg.loop_mode != "fori":
            raise ValueError("anytime=True requires loop_mode='fori' (the "
                             "deadline cuts a runtime round loop)")
        deadline = AnytimeDeadline()

    def run(r_anc, query, key, first_anchors=None, batch=None, n_rounds=None,
            n_valid=None, item_ids=None, eligible=None, pos_map=None, item_tokens=None):
        return engine_search(
            score_fn, r_anc, query, cfg, key, first_anchors=first_anchors,
            batch=batch, n_valid_items=n_valid,
            n_rounds=n_rounds, return_scores=return_scores, item_ids=item_ids,
            eligible=eligible, pos_map=pos_map, item_tokens=item_tokens,
            deadline=deadline,
        )

    run.deadline = deadline
    return run


def _rows(tree, lo: int, hi: int):
    """Rows [lo, hi) of every leaf of a batched query pytree."""
    if isinstance(tree, dict):
        return {k: _rows(v, lo, hi) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rows(v, lo, hi) for v in tree)
    return tree[lo:hi]


def make_sharded_engine(score_fn: ScoreFn, cfg: AdaCURConfig, mesh, *,
                        item_axes: Tuple[str, ...] = ("items",)) -> Callable:
    """The sharded engine over a (data x items) ``DeviceMesh``, one process
    per rank.  The returned callable has :func:`make_engine`'s signature;
    every rank calls it, with the same global query batch and key and its
    OWN slabs of the item axis: ``r_anc`` (k_q, N_local) (a coded payload's
    codes with their co-sharded tile scales), ``item_ids`` and
    ``item_tokens`` (N_local, ...), as ``AnchorIndex.shard`` /
    ``load(path, mesh)`` hold them.  ``eligible`` and ``first_anchors`` are
    global; ``n_valid`` is the global valid count.

    Inside, the whole multi-round search is :func:`engine_search` on a live
    :class:`ShardCtx`: ``item_axes`` shard the payload, the ``selected``
    slab and the id map, and per-round candidates cross shards only as
    (B, k) lists through the tie-break merge; the mesh dimensions named
    ``pod`` or ``data`` outside ``item_axes`` shard the query batch, each
    rank taking its rows by ``row_offset`` (the noise field keys off global
    rows, so the split never changes a trajectory); the pinv / ``e_q``
    state is per row and replicated over the item shards.  Every rank returns the global (B, k) result, assembled over
    the data shards, and ``anchor_idx``, ``topk_idx``, ``topk_scores`` and
    ``rounds_done`` are bitwise those of the single-device engine.

    Checked here: the global batch divides over the data shards; the slab
    holds whole ``NOISE_BLOCK`` noise blocks (more than one item shard) and
    whole payload tiles (``AnchorIndex.shard`` aligns both); every
    per-shard candidate list (``k_s``, the rerank budget, ``k_retrieve``)
    fits in one slab; and no ``pos_map`` (subset search is single-device)."""
    item_axes = (item_axes,) if isinstance(item_axes, str) else tuple(item_axes)
    data_axes = tuple(a for a in sharding.batch_axes(mesh) if a not in item_axes)
    n_item_shards = sharding.axis_size(mesh, item_axes)
    n_data_shards = sharding.axis_size(mesh, data_axes) if data_axes else 1
    item_shard = _axes_index(_dims_group(mesh, item_axes))
    data_shard = _axes_index(_dims_group(mesh, data_axes)) if data_axes else 0
    k_i = cfg.budget_ce if not cfg.split_budget else cfg.k_anchor
    k_s = k_i // cfg.n_rounds
    k_r = cfg.budget_ce - k_i if cfg.split_budget else 0

    def _validate(r_anc, b_global: int) -> int:
        n_local = r_anc.shape[1]
        capacity = n_local * n_item_shards
        if n_item_shards > 1 and n_local % sampling.NOISE_BLOCK:
            raise ValueError(f"per-shard slab {n_local} must hold whole NOISE_BLOCK="
                             f"{sampling.NOISE_BLOCK} noise blocks (AnchorIndex.shard "
                             "aligns this)")
        if isinstance(r_anc, quant.QuantizedRanc) and n_local % r_anc.tile:
            raise ValueError(f"per-shard slab {n_local} must hold whole payload tiles "
                             f"({r_anc.tile})")
        need = max(k_s, k_r, min(cfg.k_retrieve, capacity))
        if need > n_local:
            raise ValueError(f"per-shard candidate list ({need}) exceeds the per-shard "
                             f"slab ({n_local}); use fewer item shards")
        if b_global % n_data_shards:
            raise ValueError(f"batch {b_global} not divisible over {n_data_shards} "
                             "data shards")
        return n_local

    def run(r_anc, query, key, first_anchors=None, batch=None, n_rounds=None,
            n_valid=None, item_ids=None, eligible=None, pos_map=None, item_tokens=None):
        if pos_map is not None:
            raise ValueError("pos_map (candidate-subset search) is single-shard only; "
                             "pass eligible= to restrict a sharded search")
        if batch is not None:
            raise ValueError("the sharded engine derives the batch from the query leaves "
                             "(or first_anchors); pass batched query operands instead")
        r_anc = quant.as_payload(r_anc, cfg.payload_dtype, cfg.payload_tile)
        dev = r_anc.device
        b = query_batch(query, first_anchors)
        n_local = _validate(r_anc, b)
        off = item_shard * n_local
        b_local = b // n_data_shards
        lo = data_shard * b_local
        if n_valid is None:
            n_valid = n_local * n_item_shards
        if item_ids is None:
            item_ids = off + torch.arange(n_local, dtype=torch.int32, device=dev)
        if item_tokens is None and getattr(score_fn, "device_resident", False):
            table = getattr(score_fn, "item_tokens", None)   # the scorer's: global
            if table is not None:
                item_tokens = table[off:off + n_local]
        if eligible is not None:
            eligible = torch.as_tensor(eligible, device=dev).to(torch.bool)
            eligible = (eligible[off:off + n_local] if eligible.dim() == 1
                        else eligible[lo:lo + b_local, off:off + n_local])
        # the groups are looked up at each call, not held by the engine: a
        # service that tears its mesh down must drop the last reference
        ctx = ShardCtx(_dims_group(mesh, item_axes),
                       _dims_group(mesh, data_axes) if data_axes else None,
                       n_local, n_item_shards, item_shard, lo, None, n_data_shards)
        res = engine_search(
            score_fn, r_anc, _rows(query, lo, lo + b_local), cfg, key,
            first_anchors=None if first_anchors is None else first_anchors[lo:lo + b_local],
            n_valid_items=n_valid, n_rounds=n_rounds, return_scores=False,
            item_ids=item_ids, eligible=eligible, item_tokens=item_tokens, _ctx=ctx,
        )
        return AdaCURResult(
            _gather_rows(ctx, res.anchor_idx), _gather_rows(ctx, res.anchor_scores), None,
            _gather_rows(ctx, res.topk_idx), _gather_rows(ctx, res.topk_scores),
            ce_call_plan(cfg), res.rounds_done,
        )

    run.deadline = None
    return run


@runtime_checkable
class Retriever(Protocol):
    """Anything that answers a k-NN query batch under a CE-call budget."""

    def search(self, query, key=None, **kw) -> AdaCURResult:
        ...


class _IndexBacked:
    """Shared plumbing of the retrievers that consume an AnchorIndex.

    The index's tensors are read from ``self.index`` at every search, so a
    replaced index (``retriever.index = new``) is picked up.  The runtime
    ``n_valid`` bound is passed only for a padded index; an unpadded one
    keeps the static path, whose fused sampling suppresses by the anchor-id
    list.  ``cfg.payload_dtype`` is applied to the index once, at
    construction (:meth:`_apply_payload_policy`); an index that is already
    coded (int8, int4, fp8) is authoritative and passes through.  A
    subclass holds ``score_fn``, ``r_anc`` and ``index``.

    An index whose item axis is placed over a mesh (``AnchorIndex.shard`` /
    ``load(path, mesh)``) makes the retriever bind the sharded engine
    (:func:`make_sharded_engine`) instead: every rank of the mesh then
    calls ``search`` with the same query batch and key, and gets the
    global result, bit-identical to the single-device engine's."""

    def _build_engine(self, cfg: AdaCURConfig, return_scores: Optional[bool] = None,
                      anytime: bool = False) -> Callable:
        """make_engine or make_sharded_engine, by the index's placement."""
        idx = getattr(self, "index", None)
        mesh, axes = idx._item_sharding() if idx is not None else (None, None)
        self._sharded = mesh is not None
        if mesh is None:
            return make_engine(self.score_fn, cfg, return_scores=return_scores,
                               anytime=anytime)
        if anytime:
            raise ValueError("anytime deadlines are single-device only: ranks polling "
                             "their own clocks would stop on different rounds and "
                             "deadlock the collectives")
        return make_sharded_engine(self.score_fn, cfg, mesh, item_axes=axes)

    def _apply_payload_policy(self, cfg: AdaCURConfig) -> None:
        idx = self.index
        if idx is None or cfg.payload_dtype == "float32":
            return
        if idx.payload_dtype == cfg.payload_dtype or idx.payload_dtype in quant.CODE_DTYPES:
            return
        # a sharded index quantizes its own slab (re-aligning the slabs to
        # whole tiles first), keeping its placement
        self.index = idx.quantize(cfg.payload_dtype, tile=cfg.payload_tile)

    def _prep_query(self, query):
        """A scorer with a host tokenizer (``tokenize_queries``) takes token
        operands: map the query ids once, before the round loop; every
        other scorer gets the query untouched."""
        tok = getattr(self.score_fn, "tokenize_queries", None)
        return query if tok is None else tok(query)

    def _search_operands(self):
        if self.index is None:
            return self.r_anc, {}
        kw = dict(item_ids=self.index.item_ids)
        if self.index.capacity > self.index.n_items:
            kw["n_valid"] = self.index.n_valid
        if (getattr(self.score_fn, "device_resident", False)
                and self.index.item_tokens is not None):
            # the index's table is authoritative: position-aligned with the
            # payload through every mutation
            kw["item_tokens"] = self.index.item_tokens
        return self.index.r_anc, kw


@dataclass
class AdaCURRetriever(_IndexBacked):
    """The paper's method (Alg. 1) on the static-shape engine.
    ``anytime=True`` (``fori`` only) lets :meth:`search` take a
    ``deadline_t``; ``self.deadline.fired`` then says whether it cut the
    search short."""

    score_fn: ScoreFn
    r_anc: Optional[object]
    cfg: AdaCURConfig
    index: Optional[object] = None       # repro_torch.core.index.AnchorIndex
    anytime: bool = False
    _run: Callable = field(init=False, repr=False)

    def __post_init__(self):
        if self.r_anc is None and self.index is None:
            raise ValueError("need r_anc or an AnchorIndex")
        self._apply_payload_policy(self.cfg)
        self._run = self._build_engine(self.cfg, anytime=self.anytime)
        self.deadline = self._run.deadline

    @classmethod
    def from_index(cls, index, score_fn: ScoreFn, cfg: AdaCURConfig,
                   anytime: bool = False) -> "AdaCURRetriever":
        """Bind the engine to an AnchorIndex: ``score_fn`` receives external
        item ids, and a padded capacity is masked by the runtime bound."""
        return cls(score_fn, None, cfg, index=index, anytime=anytime)

    def search(self, query, key=None, first_anchors=None, batch=None,
               n_rounds=None, deadline_t=None, **_ignored) -> AdaCURResult:
        key = prng.PRNGKey(0) if key is None else key
        query = self._prep_query(query)
        r_anc, kw = self._search_operands()
        run = lambda: self._run(r_anc, query, key, first_anchors=first_anchors,  # noqa: E731
                                batch=batch, n_rounds=n_rounds, **kw)
        if deadline_t is None:
            return run()
        if self.deadline is None:
            raise ValueError("deadline_t= requires anytime=True at construction")
        self.deadline.arm(deadline_t)
        try:
            return run()
        finally:
            self.deadline.disarm()


@dataclass
class ANNCURRetriever(_IndexBacked):
    """Fixed-anchor one-round special case (Yadav et al. 2022): one
    retriever-seeded engine round over the fixed anchors, then the
    split-budget rerank, the code path ADACUR runs at ``n_rounds=1``.  With
    ``budget_ce == k_anchor`` no rerank budget is left, and the ranking is
    the free exact-score ranking of the anchors (the no-split
    configuration).  ``base_cfg`` supplies the engine's other settings
    (``use_fused_topk``, payload)."""

    score_fn: ScoreFn
    r_anc: Optional[object]
    anchor_idx: Optional[torch.Tensor]   # (k_i,) fixed anchor item positions
    budget_ce: int = 0
    k_retrieve: int = 100
    pinv_rcond: float = 1e-6
    base_cfg: Optional[AdaCURConfig] = None
    index: Optional[object] = None       # repro_torch.core.index.AnchorIndex
    _run: Callable = field(init=False, repr=False)

    def __post_init__(self):
        if self.anchor_idx is None:
            if self.index is None or self.index.anchor_item_pos is None:
                raise ValueError("need anchor_idx or an AnchorIndex with anchors "
                                 "(index.with_anchors() / with_latents())")
            k_i = int(self.index.anchor_item_pos.shape[0])
        else:
            k_i = int(self.anchor_idx.shape[0])
        if self.r_anc is None and self.index is None:
            raise ValueError("need r_anc or an AnchorIndex")
        if self.budget_ce < k_i:
            raise ValueError(f"budget_ce={self.budget_ce} < k_anchor={k_i}")
        self.cfg = replace(
            self.base_cfg or AdaCURConfig(), k_anchor=k_i, n_rounds=1,
            budget_ce=self.budget_ce, split_budget=self.budget_ce > k_i,
            first_round="retriever", k_retrieve=self.k_retrieve,
            pinv_rcond=self.pinv_rcond, round_epsilon=0.0, early_exit_tol=0.0,
        )
        self._apply_payload_policy(self.cfg)
        self._run = self._build_engine(self.cfg)

    @classmethod
    def from_index(cls, index, score_fn: ScoreFn, budget_ce: int, k_retrieve: int = 100,
                   pinv_rcond: float = 1e-6,
                   base_cfg: Optional[AdaCURConfig] = None) -> "ANNCURRetriever":
        """ANNCUR over an AnchorIndex that carries anchors; they are read
        from the index at every search."""
        return cls(score_fn, None, None, budget_ce, k_retrieve, pinv_rcond, base_cfg,
                   index=index)

    def search(self, query, key=None, **_ignored) -> AdaCURResult:
        key = prng.PRNGKey(0) if key is None else key
        query = self._prep_query(query)
        anchors = self.index.anchor_item_pos if self.anchor_idx is None else self.anchor_idx
        r_anc, kw = self._search_operands()
        b = query_batch(query)
        first = anchors.to(device=r_anc.device, dtype=torch.int32)[None, :].expand(
            b, anchors.shape[0]).contiguous()
        return self._run(r_anc, query, key, first_anchors=first, **kw)


@dataclass
class RerankRetriever(_IndexBacked):
    """Retrieve-and-rerank baseline: one retriever-seeded round, no split.
    Every candidate is exact-CE scored (they are the anchors) and the
    ranking is the free top-k of those scores: ``retrieval.rerank_baseline``
    as an engine configuration."""

    score_fn: ScoreFn
    r_anc: Optional[object]
    budget_ce: int = 0
    k_retrieve: int = 100
    base_cfg: Optional[AdaCURConfig] = None
    index: Optional[object] = None       # repro_torch.core.index.AnchorIndex
    _run: Callable = field(init=False, repr=False)

    def __post_init__(self):
        if self.r_anc is None and self.index is None:
            raise ValueError("need r_anc or an AnchorIndex")
        self.cfg = replace(
            self.base_cfg or AdaCURConfig(), k_anchor=self.budget_ce, n_rounds=1,
            budget_ce=self.budget_ce, split_budget=False, first_round="retriever",
            k_retrieve=self.k_retrieve, round_epsilon=0.0, early_exit_tol=0.0,
        )
        self._apply_payload_policy(self.cfg)
        # pure rerank never reads S_hat: no pinv/e_q machinery
        self._run = self._build_engine(self.cfg, return_scores=False)

    @classmethod
    def from_index(cls, index, score_fn: ScoreFn, budget_ce: int, k_retrieve: int = 100,
                   base_cfg: Optional[AdaCURConfig] = None) -> "RerankRetriever":
        return cls(score_fn, None, budget_ce, k_retrieve, base_cfg, index=index)

    def search(self, query, key=None, candidate_idx=None, **_ignored) -> AdaCURResult:
        if candidate_idx is None:
            raise ValueError("RerankRetriever.search needs candidate_idx (B, >= budget)")
        key = prng.PRNGKey(0) if key is None else key
        query = self._prep_query(query)
        r_anc, kw = self._search_operands()
        first = candidate_idx[:, :self.budget_ce].to(device=r_anc.device, dtype=torch.int32)
        return self._run(r_anc, query, key, first_anchors=first, **kw)


# ---------------------------------------------------------------------------
# Introspection: the fused path never materializes (B, N) scores.
# ---------------------------------------------------------------------------


def round_body_bn_intermediates(score_fn: ScoreFn, r_anc, query, cfg: AdaCURConfig,
                                batch: Optional[int] = None) -> int:
    """Number of (B, N) floating-point tensors that ONE adaptive round body
    creates (round 1 on zeroed slabs, as the reference traces it).

    The reference counts the float (B, N) outputs of the round body's jaxpr;
    the port runs eagerly, so a ``TorchDispatchMode`` counts the float
    (B, N) outputs of every aten op the body dispatches.  Dense sampling
    scores every item each round (>= 1); the fused TopK path must report 0
    (a CUDA kernel's work is invisible to the dispatcher, and it allocates
    only its (B, k) lists; the CPU plain version forms (B, tile) slabs, so
    hold the CPU count with N above the plain tile)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    r_anc = quant.as_payload(r_anc, cfg.payload_dtype, cfg.payload_tile)
    k_q, n_items = r_anc.shape
    dev = r_anc.device
    k_i = cfg.budget_ce if not cfg.split_budget else cfg.k_anchor
    k_s = k_i // cfg.n_rounds
    b = query_batch(query, batch=batch)
    keys = prng.split(prng.PRNGKey(0), cfg.n_rounds + 1)
    _, _, body = _make_round_steps(score_fn, r_anc, query, cfg, keys, k_s, None,
                                   _local_ctx(n_items))
    state = EngineState(
        anchor_idx=torch.zeros((b, k_i), dtype=torch.int32, device=dev),
        c_test=torch.zeros((b, k_i), device=dev),
        a_buf=torch.zeros((b, k_q, k_i), device=dev),
        p=torch.zeros((b, k_i, k_q), device=dev),
        e_q=torch.zeros((b, k_q), device=dev),
        selected=torch.zeros((b, n_items), dtype=torch.bool, device=dev),
    )

    class _Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and tuple(t.shape) == (b, n_items)):
                    self.n += 1
            return out

    with _Count() as counter:
        body(1, state)
    return counter.n


def engine_slab_bytes(cfg: AdaCURConfig, batch: int, n_items: int, k_q: int,
                      n_data_shards: int = 1, n_item_shards: int = 1, payload=None) -> dict:
    """Device bytes of the engine's preallocated per-search slabs (per shard
    for a (data x items) decomposition, as the reference reports them), plus
    ``"payload"`` when ``payload`` is given: a payload (its real bytes, packed
    int4 at half a byte a column) or a payload dtype name (sized from
    ``(k_q, n_items)`` and the tile scales)."""
    k_i = cfg.budget_ce if not cfg.split_budget else cfg.k_anchor
    b = batch // n_data_shards
    slabs = {
        "anchor_idx": b * k_i * 4,
        "c_test": b * k_i * 4,
        "a_buf": b * k_q * k_i * 4,
        "p": b * k_i * k_q * 4,
        "e_q": b * k_q * 4,
        "selected_mask": b * (n_items // n_item_shards) * 1,
    }
    if payload is not None:
        if isinstance(payload, str):
            nb = quant.payload_nbytes(payload, k_q, n_items, cfg.payload_tile)
        elif isinstance(payload, quant.QuantizedRanc):
            nb = payload.nbytes
        else:
            nb = payload.numel() * payload.element_size()
        slabs["payload"] = nb // n_item_shards
    slabs["total"] = sum(slabs.values())
    return slabs
