"""ADACUR retrieval service — port of ``AdaCURService`` and the serve CLI
of ``repro/launch/serve.py`` (synthetic and real cross-encoder scorers).

Requests accumulate to a batch or a deadline; a batch fires from
``submit`` when full or overdue and from ``poll``; every fired batch is
padded to one of a few static batch buckets (partial fills repeat the last
row, and the padding is cut from the responses).  A failing search turns
into per-request ``status="error"`` responses for exactly that batch.

Anytime serving: a request may carry ``deadline_t`` (absolute
``time.monotonic()``); over an ``anytime=True`` retriever the tightest
deadline in a batch governs its round loop, and a response whose search the
deadline cut is ``degraded`` (the provisional top-k of the rounds done).

The offline side enters through the :class:`AnchorIndex` artifact: pass
one, a directory it was saved to (``index=<path>``), or a bare ``r_anc``
score matrix the service wraps.  :meth:`swap_index` serves a mutated
index (``add_items`` / ``remove_items``) from the next batch on; the
requests already queued are answered under the index that admitted them
first.  ``deterministic=True`` reuses the seed key at every flush, so a
batch replays bit for bit.  ``launch/router.py`` puts replicas of this
service behind a fault-tolerant router.

CLI (on the card by default; ``--device cpu`` runs the plain versions):

    PYTHONPATH=src python -m repro_torch.launch.serve --fused \
        [--retriever adacur|anncur|rerank] [--first-stage none|de|bm25] \
        [--index-path DIR] [--scorer synthetic|real-ce] [--cache] \
        [--round-kernel staged|persistent] \
        [--payload-dtype float32|bfloat16|int8|fp8|int4] \
        [--n-items N] [--batch B] [--requests R] [--device cuda|cpu]

``--index-path DIR`` loads the index saved there, or builds it resumably
(row-block checkpoints in DIR), saves it there and drops the blocks.
``--retriever anncur`` fixes ``k_anchor`` anchors drawn from key 2 (the
reference's); ``--retriever rerank`` reranks a stand-in dual-encoder order
(``q_emb @ i_embᵀ``, index-stable top-k, a plain product).
``--first-stage de|bm25`` serves the hybrid: a dual-encoder shortlist
(through the approx_topk kernel) or a BM25 one (over the domain's
``lexical_signatures``, seed 3) of ``4 x budget`` restricts ADACUR to each
query's candidates.

``--mesh DxI`` serves over a (data x items) mesh, one process per rank:

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --mesh 2x2 --device cpu

The index is sharded over the ``items`` dimension (each rank keeps its
column slab) and the sharded engine splits each batch over ``data``.  Rank 0
reads the requests and prints; at every flush its service broadcasts the
batch to the other ranks, which run the same search in
:meth:`AdaCURService.follow` until :meth:`AdaCURService.stop_followers`.
Several sharded services may share one world as replicas behind
``launch/router.py`` (``launch.mesh.make_replica_meshes``): each follows
its own leader over its own group (``AdaCURService(group=)``), and rank 0
reaches the leaders of the replicas it does not lead through
``router.RemoteReplica``.
The backend follows the device: NCCL on the card (one card a rank; NCCL
refuses two ranks on one device), gloo on the CPU.
``--cache`` under ``--mesh``, a mesh whose size is not the world's, and a
``--batch`` whose buckets do not divide over the data shards are refused.
With ``--scorer real-ce`` the CE runs device-resident in the engine
(``DeviceCEScorer`` over the index's token table).
``--scorer real-ce`` serves the transformer cross-encoder over a
ZESHEL-like token corpus with the reference CLI's reduced CE and sizes
(``build_real_ce_domain``); ``--cache`` wraps it in a ``CachingScorer``.
"""

from __future__ import annotations

import argparse
import atexit
import gc
import json
import os
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import AdaCURConfig
from ..core import prng
from ..core.candidates import BM25Candidates, DualEncoderCandidates, HybridRetriever
from ..core.engine import AdaCURRetriever, ANNCURRetriever, RerankRetriever, Retriever
from ..core.index import AnchorIndex, clear_build_checkpoints
from ..core.scorer import (CachingScorer, CrossEncoderScorer, DeviceCEScorer, ScorerStats,
                           SyntheticScorer, scorer_stats)
from ..device import resolve_device
from ..kernels.approx_topk import quant
from ..kernels.approx_topk.select import stable_topk


# an idle sharded service's leader sends its followers a header this often
# at most, and at least six times in the timeout of the group they wait on
KEEPALIVE_S = 60.0


def keepalive_interval_s(group) -> float:
    """How often an idle sender keeps a receiver waiting on ``group`` (a
    process group or its name): a sixth of the group's own timeout, at most
    :data:`KEEPALIVE_S`."""
    pg = _resolve_group(getattr(group, "group_name", group))
    dev = torch.device("cuda" if dist.get_backend(pg) == "nccl" else "cpu")
    return min(KEEPALIVE_S, pg._get_backend(dev).options._timeout.total_seconds() / 6)


class KeepAlive:
    """A daemon thread that calls ``owner._keepalive_tick()`` four times an
    ``interval_s`` until :meth:`stop`, until the tick returns False, or
    until the owner goes: it holds the owner weakly, so an owner nobody
    holds goes (and its process groups with it) as it would without one.
    The tick must not wait on a lock that :meth:`stop`'s caller may hold.
    :meth:`stop` joins the thread, and so does the interpreter's exit, so
    no keep-alive is inside a collective when the process ends."""

    def __init__(self, owner, interval_s: float):
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=_keepalive_loop, args=(weakref.ref(owner), self._stop, interval_s / 4),
            daemon=True, name="adacur-keepalive")
        _KEEPALIVES.add(self)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=self.interval_s)


def _keepalive_loop(ref, stop: threading.Event, every_s: float) -> None:
    while not stop.wait(every_s):
        owner = ref()
        if owner is None or not owner._keepalive_tick():
            return
        del owner


_KEEPALIVES: "weakref.WeakSet[KeepAlive]" = weakref.WeakSet()


@atexit.register
def _stop_keepalives() -> None:
    for k in list(_KEEPALIVES):
        k.stop()


@dataclass
class RetrievalRequest:
    query_id: int
    arrival_t: float = field(default_factory=time.monotonic)
    deadline_t: Optional[float] = None   # absolute time.monotonic() budget; past
                                         # it the search returns the provisional
                                         # top-k (degraded=True)


@dataclass
class RetrievalResponse:
    query_id: int
    item_ids: Optional[np.ndarray] = None      # None on status="error"
    scores: Optional[np.ndarray] = None
    latency_s: float = 0.0
    ce_calls: int = 0                          # planned budget
    measured_ce_calls: Optional[int] = None    # scorer-measured, per real row
    cache_hits: Optional[int] = None           # pairs served from cache (batch)
    status: str = "ok"                         # "ok" | "error"
    degraded: bool = False                     # a deadline cut the round loop
    rounds_completed: Optional[int] = None
    error: Optional[str] = None
    batch_id: Optional[int] = None             # the service's count of batches fired before it
    batch_row: Optional[int] = None            # its row in that batch (batch_log's query_ids)


class AdaCURService:
    """Batched retrieval over an AnchorIndex via any index-backed Retriever.
    The offline side is an AnchorIndex, the directory one was saved to
    (``index``; loaded onto ``device``, the card unless ``device="cpu"``),
    or a bare ``r_anc`` score matrix, which the service wraps
    (``AnchorIndex.from_r_anc``, on ``device``).  ``candidate_fn`` (query
    ids (B,) -> (B, M) first-stage order) feeds a retriever that reranks
    candidates (``RerankRetriever``).

    ``deterministic=True`` reuses the seed key at every flush instead of
    splitting it, so a query's search is a function of its batch row and
    query id alone: a repeat query re-requests the pairs a
    ``CachingScorer`` already holds, and a batch replays bit for bit.

    Over a sharded index (``AnchorIndex.shard`` / ``load(path, mesh)``)
    every rank of the mesh runs every search.  Rank 0 takes the requests:
    at each flush it broadcasts the batch (its query ids padded to the
    bucket, and the key) over the service's ``group`` (the world unless
    given), and the other ranks, in :meth:`follow`, run the same search
    until :meth:`stop_followers`.  The leader is the group's first rank.
    The followers wait for each batch's header over ``control`` (``group``
    unless given): a replica's ``group`` and mesh may bound every
    collective of a batch by a short timeout while its followers wait for
    the next batch as long as traffic is idle.  A replica's idle leader
    (a service given its ``control`` group) keeps them waiting past that
    group's own timeout: a :class:`KeepAlive` thread of its service
    broadcasts a keep-alive header (op 3, which a follower skips) whenever
    no header went out for a sixth of that timeout
    (:func:`keepalive_interval_s`; gloo's default is 30 minutes,
    ``make_replica_meshes(control_timeout_s=)`` sets a replica's).  A
    service over the world (the serve CLI under torchrun) drives its
    batches back to back and keeps the world group's bound.
    The measured CE calls of a batch are summed over the ranks.  A search
    that raises on any rank is fatal to the mesh (the ranks' collectives no
    longer pair up): that rank ends the mesh's process groups, which makes
    every peer's pending or next collective fail, so each rank ends instead
    of waiting; the leader answers the batch, and every later one, with the
    error (``mesh_error``), and a follower's :meth:`follow` raises.  Over
    the world group that means destroying the world, as when one service
    is the whole world; a service given its own ``group`` (a replica
    behind ``launch/router.py``: ``launch.mesh.make_replica_meshes``) ends
    only its groups and its index mesh's, so the other replicas of the
    world serve on.  Ending a gloo group may close its connections only
    once its last reference goes, which the service arranges as far as it
    can; the bound is the groups' own timeout (``make_replica_meshes`` gives a
    replica's batch groups a short one), after which a peer still waiting
    fails as well.

    A sharded service swaps its index on every rank at one point of the
    batch sequence: each rank stages its slab of the new index
    (:meth:`stage_index`) beforehand, and the leader's :meth:`swap_index`
    announces the swap, after which each follower serves its next staged
    index."""

    def __init__(self, score_fn: Optional[Callable] = None, r_anc=None,
                 cfg: Optional[AdaCURConfig] = None, max_batch: int = 32,
                 max_wait_s: float = 0.01, seed: int = 0, retriever=None,
                 index: Optional[Union[AnchorIndex, str, os.PathLike]] = None,
                 candidate_fn: Optional[Callable] = None,
                 batch_buckets: Optional[List[int]] = None, deterministic: bool = False,
                 device=None, group=None, control=None):
        if index is not None and not isinstance(index, AnchorIndex):
            index = AnchorIndex.load(os.fspath(index), device=device)
        if retriever is None:
            if index is None:
                if score_fn is None or r_anc is None or cfg is None:
                    raise ValueError("need an index (AnchorIndex or path), (score_fn, "
                                     "r_anc, cfg), or a retriever")
                if not isinstance(r_anc, torch.Tensor):
                    r_anc = torch.from_numpy(np.array(r_anc, dtype=np.float32))
                index = AnchorIndex.from_r_anc(r_anc.to(resolve_device(device)))
            if score_fn is None or cfg is None:
                raise ValueError("need score_fn and cfg to build the retriever")
            retriever = AdaCURRetriever.from_index(index, score_fn, cfg)
        elif index is None:
            index = getattr(retriever, "index", None)
        self.retriever = retriever
        self.index = index
        self.candidate_fn = candidate_fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        if batch_buckets is None:
            batch_buckets = {max(1, max_batch // 4), max(1, max_batch // 2), max_batch}
        self.batch_buckets = sorted(set(int(b) for b in batch_buckets))
        if self.batch_buckets[-1] != max_batch:
            raise ValueError(f"largest bucket {self.batch_buckets[-1]} must "
                             f"equal max_batch={max_batch}")
        self._scorer = getattr(retriever, "score_fn", None)
        self._spmd = index is not None and getattr(index, "mesh", None) is not None
        self.mesh_error: Optional[str] = None   # why a sharded search tore the mesh down
        # the ranks of a sharded service (None: the world), held by name:
        # a group's connections close only when its last reference goes
        self._group_name = getattr(group, "group_name", group)
        self._control_name = (self._group_name if control is None
                              else getattr(control, "group_name", control))
        self._leader = (0 if not self._spmd or group is None
                        else dist.get_global_rank(self._group, 0))
        self._staged: List[AnchorIndex] = []
        self._n_batches = 0
        self.keepalives = 0                     # keep-alive headers sent
        self._last_header = time.monotonic()
        self.deterministic = deterministic
        self._key = prng.PRNGKey(seed)
        self._pending: List[RetrievalRequest] = []
        # one lock over the queue, index swaps and flushes: a batch is
        # popped, searched and answered under the index that admitted it
        # (reentrant: swap_index drains through flush)
        self._lock = threading.RLock()
        # per fired batch: rows, bucket, rounds, CE calls, seconds
        self.batch_log: List[dict] = []
        self._keepalive = (KeepAlive(self, keepalive_interval_s(self._control_name))
                           if self._spmd and control is not None
                           and dist.get_rank() == self._leader else None)

    def _keepalive_tick(self) -> bool:
        """The leader's keep-alive: a header on the control group once none
        went out for the interval; False once the mesh has failed.  A busy
        service (its lock held) sends headers of its own."""
        if not self._lock.acquire(blocking=False):
            return True
        try:
            if self.mesh_error is not None:
                return False
            if time.monotonic() - self._last_header >= self._keepalive.interval_s:
                self._broadcast_header(3, 0, (0, 0))
                self.keepalives += 1
            return True
        finally:
            self._lock.release()

    def _stop_keepalive(self) -> None:
        if self._keepalive is not None:
            self._keepalive.stop()

    @property
    def scorer_stats(self) -> Optional[ScorerStats]:
        return scorer_stats(self._scorer) if self._scorer is not None else None

    def stage_index(self, index: AnchorIndex) -> None:
        """Queue this rank's slab of a sharded service's next index (every
        rank stages, in the same order); the leader's :meth:`swap_index`
        switches each rank to it."""
        self._staged.append(index)

    def swap_index(self, index: Optional[AnchorIndex] = None) -> List[RetrievalResponse]:
        """Serve ``index`` (a mutated one: same capacity, so the search's
        shapes hold; None: the next staged one) from the next batch on.
        The requests already queued were admitted under the live index:
        they are flushed against it first, and their responses returned.  A
        sharded service's leader announces the swap to its followers."""
        if getattr(self.retriever, "index", None) is None:
            raise ValueError("swap_index needs an index-backed retriever (from_index); this "
                             "one was built on a bare r_anc and would keep searching it")
        with self._lock:
            drained: List[RetrievalResponse] = []
            while self._pending:
                drained += self.flush()
            if index is None:
                if not self._staged:
                    raise ValueError("swap_index() without an index needs a staged one "
                                     "(stage_index)")
                index = self._staged.pop(0)
            if self._spmd and self.mesh_error is None:
                self._broadcast_header(2, 0, (0, 0))
            self._use_index(index)
            return drained

    def _use_index(self, index: AnchorIndex) -> None:
        self.index = index
        self.retriever.index = index

    def _due(self) -> bool:
        if not self._pending:
            return False
        return (len(self._pending) >= self.max_batch
                or time.monotonic() - self._pending[0].arrival_t >= self.max_wait_s)

    def submit(self, req: RetrievalRequest) -> Optional[List[RetrievalResponse]]:
        """Queue a request; returns responses when a batch fires."""
        with self._lock:
            self._pending.append(req)
            return self.flush() if self._due() else None

    def submit_and_flush(self, requests: List[RetrievalRequest]) -> List[RetrievalResponse]:
        """Queue ``requests`` and flush until each has its response, all
        under the service's lock: a concurrent ``swap_index`` waits for the
        whole list, so no request's response is drained to the swapping
        thread and every response answers its own request, in order."""
        with self._lock:
            responses: List[RetrievalResponse] = []
            for req in requests:
                responses += self.submit(req) or []
            responses += self.flush()
            while len(responses) < len(requests):
                more = self.flush()
                if not more:
                    break
                responses += more
            return responses

    def poll(self) -> List[RetrievalResponse]:
        """Flush if the oldest queued request has waited past max_wait_s."""
        with self._lock:
            return self.flush() if self._due() else []

    @property
    def device(self) -> torch.device:
        """The device of the payload the retriever searches: its index's,
        else its bare r_anc's."""
        idx = getattr(self.retriever, "index", None)
        return (idx.r_anc if idx is not None else self.retriever.r_anc).device

    def _bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if b >= n:
                return b
        return self.batch_buckets[-1]

    def flush(self) -> List[RetrievalResponse]:
        with self._lock:
            if not self._pending:
                return []
            batch = self._pending[: self.max_batch]
            self._pending = self._pending[self.max_batch:]
            try:
                return self._flush_batch(batch)
            except Exception as e:  # noqa: BLE001 — the flush boundary
                msg = f"{type(e).__name__}: {e}"
                if self.device.type == "cuda":
                    # a search that raised between launches left work queued
                    # on this thread's stream: wait for it, as a finished
                    # flush's copies do; a device fault surfacing here is
                    # named beside the first error
                    try:
                        torch.cuda.current_stream(self.device).synchronize()
                    except RuntimeError as sync_err:
                        msg += f" (then, synchronizing the stream: {sync_err})"
            # outside the handler, so the failed search's frames (and the
            # process groups they hold) are gone when the mesh is ended
            if self._spmd:
                msg = self._fail_mesh(msg)
            now = time.monotonic()
            return [RetrievalResponse(query_id=r.query_id, latency_s=now - r.arrival_t,
                                      status="error", error=msg)
                    for r in batch]

    def _flush_batch(self, batch: List[RetrievalRequest]) -> List[RetrievalResponse]:
        t0 = time.perf_counter()
        n_real = len(batch)
        bucket = self._bucket(n_real)
        raw = [r.query_id for r in batch] + [batch[-1].query_id] * (bucket - n_real)
        # positions map through the retriever's own index (it may have been
        # replaced directly); a retriever over a bare r_anc answers positions
        idx = getattr(self.retriever, "index", None)
        qids = torch.tensor(raw, dtype=torch.int64, device=self.device)
        if self.deterministic:
            sub = self._key
        else:
            self._key, sub = prng.split(self._key)
        if self.mesh_error is not None:
            raise RuntimeError(f"the mesh was torn down by an earlier batch: {self.mesh_error}")
        if self._spmd:
            self._announce(qids, sub)
        batch_id = self._n_batches
        self._n_batches += 1
        kw = {}
        if self.candidate_fn is not None:
            kw["candidate_idx"] = self.candidate_fn(qids)
        # one round loop serves every row, so the tightest deadline governs
        holder = getattr(self.retriever, "deadline", None)
        budgets = [r.deadline_t for r in batch if r.deadline_t is not None]
        if budgets and holder is not None:
            kw["deadline_t"] = min(budgets)
        before = self.scorer_stats
        before = before.copy() if before is not None else None
        res = self.retriever.search(qids, sub, **kw)
        top = idx.gather_item_ids(res.topk_idx) if idx is not None else res.topk_idx
        ranks_delta = self._ranks_delta(before) if self._spmd else None
        # blocking copies: the search's work on this thread's stream has run
        # when they return, so no flush leaves work queued that reads an
        # index a concurrent swap_index may then free (the router's index
        # handoff between replica streams rests on this)
        item_ids = top.cpu().numpy()
        scores = res.topk_scores.cpu().numpy()
        degraded = bool(holder.fired) if "deadline_t" in kw else False
        rounds = int(res.rounds_done)
        measured = cache_hits = None
        if before is not None:
            delta = ranks_delta if ranks_delta is not None else self.scorer_stats - before
            # amortized over the real requests: padded rows are a cost of
            # serving them
            measured = delta.ce_calls // n_real
            cache_hits = delta.cache_hits
            self.batch_log.append(dict(rows=n_real, bucket=bucket, rounds=rounds,
                                       ce_calls=delta.ce_calls, pairs=delta.pairs,
                                       cache_hits=delta.cache_hits, batch_pad=delta.batch_pad,
                                       seconds=time.perf_counter() - t0, batch_id=batch_id,
                                       query_ids=raw))
        now = time.monotonic()
        return [RetrievalResponse(
            query_id=r.query_id, item_ids=item_ids[i], scores=scores[i],
            latency_s=now - r.arrival_t, ce_calls=res.ce_calls,
            measured_ce_calls=measured, cache_hits=cache_hits, degraded=degraded,
            rounds_completed=rounds, batch_id=batch_id, batch_row=i,
        ) for i, r in enumerate(batch)]


    # -- the sharded service's ranks ------------------------------------------

    # (op, bucket, key word 0, key word 1); op 0 stop, 1 batch, 2 swap, 3 keep-alive
    _HEADER = 4

    @property
    def _group(self):
        return _resolve_group(self._group_name)

    @property
    def _control(self):
        return _resolve_group(self._control_name)

    def _broadcast_header(self, op: int, bucket: int, key_words) -> None:
        hdr = torch.tensor([op, bucket, *key_words], dtype=torch.int64, device=self.device)
        dist.broadcast(hdr, src=self._leader, group=self._control)
        self._last_header = time.monotonic()

    def _announce(self, qids: torch.Tensor, key) -> None:
        """The leader: send one batch to the following ranks."""
        self._broadcast_header(1, qids.shape[0], key.to(torch.int64).reshape(-1).tolist())
        dist.broadcast(qids.contiguous(), src=self._leader, group=self._group)

    def _ranks_delta(self, before: Optional[ScorerStats]) -> Optional[ScorerStats]:
        """This batch's scorer counts summed over the ranks (every rank
        calls it after the search)."""
        if before is None:
            return None
        d = self.scorer_stats - before
        t = torch.tensor([d.ce_calls, d.pairs, d.cache_hits, d.requests, d.batch_pad],
                         dtype=torch.int64, device=self.device)
        dist.all_reduce(t, group=self._group)
        d.ce_calls, d.pairs, d.cache_hits, d.requests, d.batch_pad = t.tolist()
        return d

    def _mesh_groups(self) -> list:
        """The process groups this service's ranks share: its own group, its
        control group and its index mesh's dimensions' (the world's, without
        a group)."""
        mesh = getattr(self.retriever, "index", None)
        mesh = getattr(mesh, "mesh", None)
        groups = [self._group, self._control] + (list(mesh.get_all_groups())
                                                 if mesh is not None else [])
        out = []
        for g in groups:
            if g is not None and all(g is not h for h in out):
                out.append(g)
        return out

    def _fail_mesh(self, msg: str) -> str:
        """A sharded search raised on this rank: record why and end the
        mesh's process groups (the first time), so every peer's pending or
        next collective fails instead of waiting for this rank: the world
        for a service over the world, else only the service's own groups
        (a group's connections may close only when its last reference
        goes, so the engine looks its groups up at each call and the caller
        holds no failed search's frames; where a reference survives, the
        groups' timeout bounds the peers' wait).  Returns the message, with a
        failure of the teardown itself named beside it."""
        if self.mesh_error is not None:
            return msg
        self.mesh_error = msg
        self._stop_keepalive()
        if not dist.is_initialized():
            return msg
        # a DeviceMesh built from groups may keep them in a registry of its
        # own (_pg_registry), which would keep their connections open
        mesh = getattr(getattr(self.retriever, "index", None), "mesh", None)
        try:
            if self._group_name is None and self._control_name is None:
                names = [g.group_name for g in self._mesh_groups()]
                dist.destroy_process_group()
                # the world's groups, ended, go now rather than at the
                # interpreter's exit
                for name in names:
                    getattr(mesh, "_pg_registry", {}).pop(name, None)
                gc.collect()
                return msg
            groups = self._mesh_groups()
            self._group_name = self._control_name = None
            for g in groups:
                getattr(mesh, "_pg_registry", {}).pop(g.group_name, None)
            gc.collect()
            for g in groups:
                dist.destroy_process_group(g)
        except (RuntimeError, ValueError) as err:
            msg += f" (then, ending the mesh's groups: {err})"
        return msg

    def follow(self) -> int:
        """Ranks other than the leader: run each batch it announces, until
        it stops the followers.  Returns the number of batches run.  A
        failure here, or the leader's teardown after one of its own, ends
        the mesh's groups and raises."""
        n = 0
        failed = None
        try:
            while True:
                hdr = torch.empty(self._HEADER, dtype=torch.int64, device=self.device)
                dist.broadcast(hdr, src=self._leader, group=self._control)
                op, bucket, k0, k1 = hdr.tolist()
                if op == 0:
                    return n
                if op == 2:
                    self._use_index(self._staged.pop(0))
                    continue
                if op == 3:          # the leader's keep-alive
                    continue
                qids = torch.empty(bucket, dtype=torch.int64, device=self.device)
                dist.broadcast(qids, src=self._leader, group=self._group)
                kw = {}
                if self.candidate_fn is not None:
                    kw["candidate_idx"] = self.candidate_fn(qids)
                before = self.scorer_stats
                before = before.copy() if before is not None else None
                res = self.retriever.search(qids, torch.tensor([k0, k1], dtype=torch.int64),
                                            **kw)
                self.retriever.index.gather_item_ids(res.topk_idx)
                self._ranks_delta(before)
                n += 1
        except Exception as e:  # noqa: BLE001 — re-raised below, after the teardown
            failed = _without_frames(e)
        # outside the handler: the failed search's frames are gone
        self._fail_mesh(f"{type(failed).__name__}: {failed}")
        raise failed

    def stop_followers(self) -> None:
        """The leader: end every other rank's :meth:`follow` (a mesh already
        torn down has no followers left)."""
        self._stop_keepalive()
        with self._lock:
            if self._spmd and self.mesh_error is None:
                self._broadcast_header(0, 0, (0, 0))


def _resolve_group(name: Optional[str]):
    """The live process group named ``name`` (None: the world)."""
    if name is None:
        return None
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


def _without_frames(e: BaseException) -> BaseException:
    """``e`` with its traceback, and its context's, dropped: the frames of
    a failed search hold its process groups."""
    seen, x = set(), e
    while x is not None and id(x) not in seen:
        seen.add(id(x))
        x.__traceback__ = None
        x = x.__context__
    return e


DEFAULT_N_ITEMS = 10000


def saved_n_items(index_path: Optional[str]) -> Optional[int]:
    """The item count of the index saved at ``index_path``, or None."""
    meta = os.path.join(index_path, "index_meta.json") if index_path else None
    if meta is None or not os.path.exists(meta):
        return None
    with open(meta) as f:
        return int(json.load(f)["n_items"])


def build_domain(n_items: int, device=None, n_queries: int = 600,
                 n_anchor_queries: int = 500, block_rows: int = 128,
                 index_path: Optional[str] = None, with_index: bool = True):
    """The CLI's synthetic domain and its AnchorIndex (anchor queries
    0..n_anchor_queries-1) on ``device``.  With ``index_path`` the index
    saved there is loaded; if none is, it is built resumably (row-block
    checkpoints in ``index_path``), saved there, and the blocks dropped; a
    saved index of another item count than ``n_items`` is refused."""
    from ..data.synthetic import make_synthetic_ce

    saved = saved_n_items(index_path)
    if saved is not None and saved != n_items:
        raise ValueError(f"the index at {index_path} holds {saved} items, not {n_items}")
    dev = resolve_device(device)
    ce = make_synthetic_ce(prng.PRNGKey(0), n_queries=n_queries, n_items=n_items,
                           device=dev)
    if not with_index:
        return ce, None
    if saved is not None:
        print(f"loading AnchorIndex from {index_path}...")
        return ce, AnchorIndex.load(index_path, device=dev)
    index = AnchorIndex.build(
        ce.score_block, torch.arange(n_anchor_queries, device=dev),
        torch.arange(n_items, device=dev), block_rows=block_rows,
        checkpoint_dir=index_path,
    )
    if index_path:
        index.save(index_path)
        clear_build_checkpoints(index_path)   # the saved index supersedes them
        print(f"saved AnchorIndex to {index_path}")
    return ce, index


def reduced_ce_config(vocab_size: int):
    """The reference CLI's reduced CPU-friendly CE (``ce-tiny`` at 2 layers,
    d_model 64, fp32)."""
    from ..configs.base import replace
    from ..configs.registry import CE_TINY

    return replace(CE_TINY, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   head_dim=16, d_ff=128, vocab_size=vocab_size, dtype="float32",
                   remat=False)


def build_real_ce_domain(n_items: int, n_anchor_q: int, n_serve_q: int, cfg=None,
                         device=None, micro_batch: int = 64,
                         build_micro_batch: Optional[int] = None):
    """The real-CE serving domain, as the reference CLI builds it: a
    ZESHEL-like token corpus (seed 0; 24-token items, 16-token queries), a
    cross-encoder of config ``cfg`` (default: the reference CLI's reduced
    CE) drawn from seed 0, and an AnchorIndex built from the CE itself over
    anchor queries 0..n_anchor_q-1, block-streamed with
    ``build_micro_batch``-pair forwards (default ``micro_batch``).  Queries
    n_anchor_q..n_anchor_q + n_serve_q - 1 are the ones to serve.

    Returns (dataset, params, serving scorer, index); the serving scorer
    runs ``micro_batch``-pair forwards and its stats start at zero.
    """
    from ..data.synthetic import make_zeshel_like
    from ..models.cross_encoder import init_cross_encoder

    dev = resolve_device(device)
    ds = make_zeshel_like(0, n_items=n_items, n_queries=n_anchor_q + n_serve_q,
                          item_len=24, query_len=16)
    if cfg is None:
        cfg = reduced_ce_config(ds.vocab_size)
    params = init_cross_encoder(cfg, torch.Generator().manual_seed(0), dev)
    indexer = CrossEncoderScorer(params, cfg, ds.pair_tokens, flash_block=(64, 64),
                                 micro_batch=build_micro_batch or micro_batch)
    index = AnchorIndex.build(indexer.score_block, torch.arange(n_anchor_q, device=dev),
                              torch.arange(n_items, device=dev), block_rows=32)
    scorer = CrossEncoderScorer(params, cfg, ds.pair_tokens, flash_block=(64, 64),
                                micro_batch=micro_batch)
    return ds, params, scorer, index


def quantize_for_serving(index: AnchorIndex, cfg: AdaCURConfig, say=print) -> AnchorIndex:
    """The index under the config's payload policy, once before serving;
    prints the payload's bytes against fp32's, as the reference CLI does
    (a sharded index's: this rank's)."""
    if cfg.payload_dtype == "float32":
        return index
    fp32_bytes = quant.payload_nbytes("float32", index.k_q, index.local_capacity)
    index = index.quantize(cfg.payload_dtype, tile=cfg.payload_tile)
    say(f"payload {cfg.payload_dtype}: {index.payload_nbytes / 1e6:.1f} MB "
        f"(fp32 would be {fp32_bytes / 1e6:.1f} MB)")
    return index


def make_retriever(kind: str, index: AnchorIndex, score_fn: Callable, cfg: AdaCURConfig,
                   anchor_key=None, anytime: bool = False) -> Retriever:
    """The CLI's retriever factory: every method consumes the same index.
    ANNCUR and rerank take ``cfg`` as their base config (the reference
    leaves them on the default one), so ``--fused`` and the payload reach
    their engine too; their ids are the same either way."""
    if kind == "adacur":
        return AdaCURRetriever.from_index(index, score_fn, cfg, anytime=anytime)
    if kind == "anncur":
        if index.anchor_item_pos is None:
            index = index.with_anchors(k_anchor=cfg.k_anchor, key=prng.PRNGKey(2)
                                       if anchor_key is None else anchor_key)
        return ANNCURRetriever.from_index(index, score_fn, budget_ce=cfg.budget_ce,
                                          k_retrieve=cfg.k_retrieve, base_cfg=cfg)
    if kind == "rerank":
        return RerankRetriever.from_index(index, score_fn, budget_ce=cfg.budget_ce,
                                          k_retrieve=cfg.k_retrieve, base_cfg=cfg)
    raise ValueError(f"unknown retriever '{kind}' (adacur|anncur|rerank)")


def de_order(ce, k: int) -> Callable:
    """The CLI's stand-in first stage for ``--retriever rerank``: each
    query's top-``k`` items by the dual-encoder product ``q_emb @ i_embᵀ``
    (a plain product and an index-stable top-k, outside any kernel)."""
    def candidate_fn(qids):
        return stable_topk(ce.q_emb[qids.long()] @ ce.i_emb.T, k)[1]
    return candidate_fn


def drive(svc: AdaCURService, n_requests: int, qid_range=(500, 600),
          seed: int = 0) -> List[RetrievalResponse]:
    """Submit ``n_requests`` query ids drawn from ``qid_range``, polling
    as an event loop would, then flush the rest."""
    served: List[RetrievalResponse] = []
    rng = np.random.default_rng(seed)
    for _ in range(n_requests):
        served += svc.submit(RetrievalRequest(query_id=int(rng.integers(*qid_range)))) or []
        served += svc.poll()
    while svc._pending:
        served += svc.flush()
    return served


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--n-items", type=int, default=None,
                    help=f"corpus size (default: the --index-path index's, else "
                         f"{DEFAULT_N_ITEMS})")
    ap.add_argument("--budget", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--fused", action="store_true",
                    help="fused score->top-k sampling (the CUDA kernels on the card)")
    ap.add_argument("--round-kernel", choices=("staged", "persistent"), default="staged")
    ap.add_argument("--payload-dtype", choices=quant.PAYLOAD_DTYPES, default="float32")
    ap.add_argument("--scorer", choices=("synthetic", "real-ce"), default="synthetic",
                    help="real-ce: the transformer cross-encoder over a ZESHEL-like corpus")
    ap.add_argument("--cache", action="store_true",
                    help="wrap the real-CE scorer in a (query, item) CachingScorer")
    ap.add_argument("--retriever", choices=("adacur", "anncur", "rerank"), default="adacur",
                    help="search method over the index")
    ap.add_argument("--first-stage", choices=("none", "de", "bm25"), default="none",
                    help="a dual-encoder (de) or BM25 (bm25) shortlist restricts ADACUR "
                         "to each query's candidates (needs --retriever adacur)")
    ap.add_argument("--index-path", default=None,
                    help="AnchorIndex directory: loaded when present, else built there "
                         "resumably and saved")
    ap.add_argument("--mesh", default=None, metavar="DATAxITEMS",
                    help="serve over a (data x items) mesh, e.g. 2x2, one process per rank "
                         "(torchrun): items shards the index payload, data the batches")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    owns_world = not dist.is_initialized()
    mesh = _serving_mesh(args, owns_world) if args.mesh else None
    if mesh is None or not owns_world:
        return _main(args, mesh)
    from .mesh import end_world

    # the world this CLI made ends on every path (a failed search already
    # ended it; an error elsewhere may leave a peer that never arrives)
    try:
        _main(args, mesh)
    except BaseException:
        end_world(sync=False)
        raise
    end_world()


def _main(args, mesh) -> None:
    if args.first_stage != "none" and args.retriever != "adacur":
        raise SystemExit("--first-stage composes the hybrid on top of ADACUR; use "
                         "--retriever adacur (rerank already is a first-stage method)")
    if args.scorer == "real-ce" and args.retriever == "rerank":
        raise SystemExit("--retriever rerank over the real CE has no first stage to rerank: "
                         "the reference's CLI wires none either (ROADMAP.md, queue 1, item 3); "
                         "use --retriever adacur or anncur, or --scorer synthetic, whose "
                         "dual-encoder order it reranks")
    if args.first_stage != "none" and args.scorer != "synthetic":
        raise SystemExit(f"--first-stage {args.first_stage} needs the synthetic domain's "
                         "embeddings: use --scorer synthetic")
    if args.index_path and args.scorer != "synthetic":
        raise SystemExit("--index-path serves the synthetic domain's index: use "
                         "--scorer synthetic")
    if args.cache and args.scorer != "real-ce":
        raise SystemExit("--cache wraps the real-CE scorer: pass --scorer real-ce")
    if args.scorer == "real-ce":
        return _serve_real_ce(args, mesh)
    cfg = AdaCURConfig(
        k_anchor=args.budget // 2, n_rounds=args.rounds, budget_ce=args.budget,
        strategy="topk", k_retrieve=100, loop_mode="fori",
        use_fused_topk=args.fused, payload_dtype=args.payload_dtype,
        round_kernel=args.round_kernel,
    )
    n_items = args.n_items or saved_n_items(args.index_path) or DEFAULT_N_ITEMS
    say = _leader_print(mesh)
    say(f"building synthetic CE domain + AnchorIndex (|I|={n_items})...")
    if mesh is not None and args.index_path:
        # rank 0 builds and saves the index once; every rank then reads only
        # its columns
        if dist.get_rank() == 0:
            build_domain(n_items, args.device, index_path=args.index_path)
        dist.barrier()
        ce = build_domain(n_items, args.device, index_path=args.index_path,
                          with_index=False)[0]
        index = AnchorIndex.load(args.index_path, device=ce.device, mesh=mesh)
        index = quantize_for_serving(index, cfg, say)
    else:
        ce, index = build_domain(n_items, args.device, index_path=args.index_path)
        index = quantize_for_serving(index, cfg, say)
        if mesh is not None:
            index = _shard_for_serving(index, mesh, say)
    scorer = SyntheticScorer(ce)
    candidate_fn = None
    if args.first_stage != "none":
        shortlist = min(4 * cfg.budget_ce, index.n_items)
        if args.first_stage == "de":
            generator = DualEncoderCandidates(ce.q_emb, ce.i_emb, n_valid=index.n_items)
        else:
            from ..data.synthetic import lexical_signatures

            generator = BM25Candidates(lexical_signatures(ce.i_emb, seed=3),
                                       lexical_signatures(ce.q_emb, seed=3),
                                       n_valid=index.n_items, device=ce.device)
        retriever = HybridRetriever(score_fn=scorer, generator=generator, cfg=cfg,
                                    index=index, shortlist_k=shortlist, mode="mask")
        say(f"first stage: {args.first_stage} shortlist_k={shortlist} (CE budget "
            "restricted to each query's candidates)")
    else:
        retriever = make_retriever(args.retriever, index, scorer, cfg)
        if args.retriever == "rerank":
            candidate_fn = de_order(ce, cfg.budget_ce)
    svc = AdaCURService(retriever=retriever, max_batch=args.batch, candidate_fn=candidate_fn)
    served = _serve(svc, args.requests)
    if served is None:
        return
    lat = np.array([r.latency_s for r in served])
    errors = sum(r.status != "ok" for r in served)
    print(f"[{args.retriever}{'/' + args.first_stage if args.first_stage != 'none' else ''}"
          f"{'/mesh ' + args.mesh if mesh is not None else ''}] "
          f"served {len(served)} requests ({errors} errors) | "
          f"p50={np.percentile(lat, 50) * 1e3:.1f}ms p99={np.percentile(lat, 99) * 1e3:.1f}ms "
          f"| {cfg.budget_ce} CE calls/request")
    if mesh is not None:
        print(f"measured: {sum(b['ce_calls'] for b in svc.batch_log)} CE calls over "
              f"{dist.get_world_size()} ranks")


def _serving_mesh(args, owns_world: bool = False):
    """``--mesh DxI`` -> the (data x items) mesh over this process's world,
    after the refusals that need no world: ``--cache`` (the sharded engine
    scores device-resident or through item shard 0, never through a host
    cache) and a batch whose buckets do not divide over the data shards.
    A world made here (``owns_world``) for a mesh it cannot hold is ended
    before the refusal."""
    from .mesh import end_world, make_serving_mesh

    try:
        d, i = (int(x) for x in args.mesh.lower().split("x"))
    except ValueError as e:
        raise SystemExit(f"--mesh must be DATAxITEMS (e.g. 2x2): {e}")
    if args.cache:
        raise SystemExit("--cache wraps a host scorer; under --mesh the real CE scores "
                         "device-resident in the sharded engine and its pairs never reach "
                         "a host cache: drop --cache")
    if args.batch % (4 * d):
        raise SystemExit(f"--batch {args.batch} must divide into the service's batch buckets "
                         f"over {d} data shards (make it a multiple of {4 * d})")
    resolve_device(args.device)        # the device rule before any process group
    if not dist.is_initialized() and "RANK" not in os.environ:
        raise SystemExit(f"--mesh {args.mesh} runs one process per rank: launch it with "
                         f"torchrun --nproc-per-node {d * i}")
    try:
        return make_serving_mesh(d, i, device=args.device)
    except ValueError as e:
        if owns_world:
            end_world(sync=False)
        raise SystemExit(f"--mesh {args.mesh}: {e} (launch with torchrun --nproc-per-node "
                         f"{d * i})")


def _leader_print(mesh) -> Callable:
    """``print`` on rank 0 (or without a mesh), silence elsewhere."""
    if mesh is None or dist.get_rank() == 0:
        return print
    return lambda *a, **k: None


def _shard_for_serving(index: AnchorIndex, mesh, say=print) -> AnchorIndex:
    """Place the index's item axis over the mesh; the retriever then binds
    the sharded engine (``engine.make_sharded_engine``)."""
    sharded = index.shard(mesh)
    say(f"sharding index over mesh {dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))} "
        f"(payload per item shard {sharded.payload_nbytes / 1e6:.1f} MB)")
    return sharded


def _serve(svc: AdaCURService, n_requests: int, **kw) -> Optional[List[RetrievalResponse]]:
    """Rank 0 (or a service without a mesh) drives the requests; the other
    ranks follow until rank 0 stops them, and get None.  A search that
    failed on any rank ends every rank with an error (the world is gone)."""
    if not svc._spmd:
        return drive(svc, n_requests, **kw)
    if dist.get_rank() != 0:
        svc.follow()
        return None
    try:
        served = drive(svc, n_requests, **kw)
    finally:
        svc.stop_followers()
    if svc.mesh_error is not None:
        errors = sum(r.status != "ok" for r in served)
        raise SystemExit(f"the mesh was torn down by a failed search ({errors} of "
                         f"{len(served)} requests answered with its error): {svc.mesh_error}")
    return served


def _serve_real_ce(args, mesh=None) -> None:
    """Serve the real CE with the reference CLI's sizes: its reduced CE,
    at most 500 items, 100 anchor + 100 served queries, k_retrieve 50.
    Under a mesh the CE runs device-resident in the sharded engine: a
    ``DeviceCEScorer`` over the index's token table, sharded with the
    payload."""
    say = _leader_print(mesh)
    n_items = min(args.n_items or DEFAULT_N_ITEMS, 500)
    n_anchor_q = n_serve_q = 100
    say(f"building ZESHEL-like corpus (|I|={n_items}) + transformer CE + "
        "AnchorIndex from the CE...")
    ds, params, scorer, index = build_real_ce_domain(n_items, n_anchor_q, n_serve_q,
                                                     device=args.device, micro_batch=64)
    serve_scorer = CachingScorer(scorer) if args.cache else scorer
    if mesh is not None:
        serve_scorer = DeviceCEScorer(params, scorer.cfg,
                                      query_token_fn=lambda q: ds.query_tokens[q],
                                      flash_block=(64, 64))
        index = index.with_item_tokens(torch.as_tensor(ds.item_tokens))
    cfg = AdaCURConfig(
        k_anchor=args.budget // 2, n_rounds=args.rounds, budget_ce=args.budget,
        strategy="topk", k_retrieve=50, loop_mode="fori",
        use_fused_topk=args.fused, payload_dtype=args.payload_dtype,
        round_kernel=args.round_kernel,
    )
    index = quantize_for_serving(index, cfg, say)
    if mesh is not None:
        index = _shard_for_serving(index, mesh, say)
    svc = AdaCURService(retriever=make_retriever(args.retriever, index, serve_scorer, cfg),
                        max_batch=args.batch)
    served = _serve(svc, args.requests, qid_range=(n_anchor_q, n_anchor_q + n_serve_q))
    if served is None:
        return
    lat = np.array([r.latency_s for r in served])
    errors = sum(r.status != "ok" for r in served)
    print(f"[real-ce{'/mesh ' + args.mesh if mesh is not None else ''}] served {len(served)} "
          f"requests ({errors} errors) | "
          f"p50={np.percentile(lat, 50) * 1e3:.1f}ms p99={np.percentile(lat, 99) * 1e3:.1f}ms "
          f"| {cfg.budget_ce} CE calls/request")
    if mesh is not None:
        log = svc.batch_log
        print(f"device-resident CE: {sum(b['ce_calls'] for b in log)} measured CE calls over "
              f"{dist.get_world_size()} ranks, {sum(b['batch_pad'] for b in log)} item-shard "
              f"pad rows excluded; {serve_scorer.n_traces} CE shapes on rank 0")
        return
    stats = svc.scorer_stats
    print(f"measured: {stats.ce_calls} CE calls, {stats.cache_hits} cache hits "
          f"({stats.cache_size} resident pairs); {scorer.n_traces} CE shapes, "
          f"{scorer.stats.batch_pad} padded micro-batch rows")


if __name__ == "__main__":
    main()
