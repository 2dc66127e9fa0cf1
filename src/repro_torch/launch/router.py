"""Fault-tolerant replica router over :class:`AdaCURService` replicas: the
port of ``repro/launch/router.py``.

N replicas (one worker thread each) behind a router that owns the request
lifecycle end to end.  The contract is **zero lost requests**: every
admitted request gets exactly one terminal outcome (results, degraded
results, a per-request error, or an explicit rejection), whatever scorer
crashes, stalled replicas and mid-flight index swaps occur.

- **Admission control**: at most ``queue_limit`` tickets in flight; past
  it a request is shed at once with a ``REJECTED`` outcome.
- **Deadlines, anytime**: a request's ``deadline_s`` rides into the
  replica's service and the engine's round loop; a search cut short
  answers with the provisional top-k of its completed rounds
  (``degraded``).
- **Hedging**: a dispatch unresolved after ``hedge_after_s`` is sent to a
  second replica; the first terminal response wins (compare-and-set on
  the ticket) and the other is dropped.
- **Retry with backoff**: an error outcome is retried on another replica
  up to ``max_retries`` times, with linear backoff, before it is terminal.
- **Health and quarantine**: each replica runs a
  :class:`~repro_torch.distributed.fault_tolerance.StragglerWatchdog` over
  one fleet-wide baseline; ``patience`` straggler batches, or
  ``max_consecutive_errors`` all-error batches, quarantine the replica and
  drain its queue to healthy peers.

**Replicas on one card.**  Where the services' index lives on a CUDA
device, every replica owns a ``torch.cuda.Stream`` and its worker serves
under it, so the kernels it launches, its deadline polls and its
watchdog's timing see only its own work.  Every replica stream waits on
the constructing thread's stream at construction, and on the swapping
thread's stream at :meth:`swap_index`, before it may read an index made
there.  Replicas share one index (one copy of the payload) and must not
share a scorer or a retriever: ``TabulatedScorer`` moves its table at its
first call, and an ``AnytimeDeadline`` is armed per search.  An old index
is freed only after a swap has taken every replica's service lock, and
every flush ends in blocking copies to the host (error flushes in a
synchronize), so no replica stream still reads it then.  Services on the
CPU take no streams.

Deterministic failure schedules come from :class:`~repro_torch.launch.
faults.FaultPlan` (a scorer raising on call k, replica stalls, a swap at
admission n).
"""

from __future__ import annotations

import contextlib
import json
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..distributed.fault_tolerance import StragglerWatchdog
from .faults import FaultPlan
from .serve import (AdaCURService, KeepAlive, RetrievalRequest, RetrievalResponse,
                    keepalive_interval_s)

OK = "ok"
ERROR = "error"
REJECTED = "rejected"

_POISON = None  # queue sentinel for worker shutdown


@dataclass
class RouterResponse:
    """The single terminal outcome of one routed request."""

    seq: int
    query_id: int
    status: str                              # "ok" | "error" | "rejected"
    response: Optional[RetrievalResponse] = None
    replica: Optional[int] = None            # replica whose answer won
    attempts: int = 0                        # dispatches issued (0 = rejected)
    hedged: bool = False                     # a hedge dispatch was issued
    retried: bool = False                    # at least one retry was issued
    latency_s: float = 0.0

    @property
    def degraded(self) -> bool:
        return bool(self.response is not None and self.response.degraded)


class Ticket:
    """One admitted request's lifecycle.

    A ticket may be dispatched to several replicas (hedge, retry, drain);
    :meth:`resolve` is a compare-and-set: the first terminal outcome wins,
    every later one returns ``False`` and is dropped.
    """

    def __init__(self, seq: int, query_id: int, deadline_t: Optional[float],
                 submit_t: float):
        self.seq = seq
        self.query_id = query_id
        self.deadline_t = deadline_t
        self.submit_t = submit_t
        self.done = threading.Event()
        self.outcome: Optional[RouterResponse] = None
        self.lock = threading.Lock()
        self.replicas_tried: List[int] = []
        self.dispatch_t: float = submit_t
        self.hedged = False
        self.failures = 0
        self.retry_at: Optional[float] = None   # backoff schedule (monitor)

    @property
    def resolved(self) -> bool:
        return self.done.is_set()

    def resolve(self, status: str, response: Optional[RetrievalResponse] = None,
                replica: Optional[int] = None) -> bool:
        with self.lock:
            if self.done.is_set():
                return False
            self.outcome = RouterResponse(
                seq=self.seq, query_id=self.query_id, status=status,
                response=response, replica=replica,
                attempts=len(self.replicas_tried),
                hedged=self.hedged, retried=self.failures > 0,
                latency_s=time.monotonic() - self.submit_t,
            )
            self.done.set()
            return True


class Replica:
    """One service + worker thread + health state behind the router; on a
    CUDA device also the stream its worker serves under."""

    def __init__(self, rid: int, service: AdaCURService,
                 stream: Optional["torch.cuda.Stream"] = None):
        self.rid = rid
        self.service = service
        self.stream = stream
        self.q: "queue.Queue" = queue.Queue()
        self.healthy = True
        self.step = 0
        self.consecutive_errors = 0
        self.served = 0
        self.watchdog: Optional[StragglerWatchdog] = None
        self.thread: Optional[threading.Thread] = None


class Router:
    """Admission control + dispatch + hedging + quarantine over N replicas.

    ``services`` are independent :class:`AdaCURService` instances (their
    own retrievers and scorers; they may share one index).  For anytime
    deadlines the retrievers are built with ``anytime=True``; the router
    passes each request's budget through regardless, and a retriever
    without a deadline serves the full search.  Services whose index is
    on a CUDA device need that device (the device rule): without a card
    the router raises.
    """

    def __init__(
        self,
        services: Sequence[AdaCURService],
        queue_limit: int = 64,
        hedge_after_s: Optional[float] = None,
        max_retries: int = 1,
        retry_backoff_s: float = 0.01,
        max_consecutive_errors: int = 3,
        plan: Optional[FaultPlan] = None,
        swap_index_fn: Optional[Callable[[], object]] = None,
        watchdog_threshold: float = 3.0,
        watchdog_window: int = 40,
        watchdog_patience: int = 2,
        monitor_interval_s: float = 0.002,
    ):
        if not services:
            raise ValueError("need at least one replica service")
        self.queue_limit = queue_limit
        self.hedge_after_s = hedge_after_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.max_consecutive_errors = max_consecutive_errors
        self.plan = plan
        self.swap_index_fn = swap_index_fn
        self.monitor_interval_s = monitor_interval_s

        self._lock = threading.Lock()
        self._seq = 0
        self._admitted = 0
        self._live: Dict[int, Ticket] = {}
        self._running = True
        self.stats: Dict[str, int] = {
            "submitted": 0, "admitted": 0, "rejected": 0, "ok": 0,
            "errors": 0, "degraded": 0, "hedges": 0, "retries": 0,
            "quarantines": 0, "swaps": 0,
        }
        self.quarantined: List[int] = []

        baseline = StragglerWatchdog.shared_baseline(watchdog_window)
        self.replicas: List[Replica] = []
        for rid, svc in enumerate(services):
            rep = Replica(rid, svc, self._replica_stream(svc))
            rep.watchdog = StragglerWatchdog(
                threshold=watchdog_threshold, window=watchdog_window,
                patience=watchdog_patience,
                on_straggler=(
                    lambda st, rep=rep: self._quarantine(rep, f"straggler: {st.seconds:.3f}s")
                ),
                baseline=baseline,
            )
            rep.thread = threading.Thread(target=self._worker, args=(rep,),
                                          name=f"replica-{rid}", daemon=True)
            self.replicas.append(rep)
        for rep in self.replicas:
            rep.thread.start()
        self._monitor_thread = threading.Thread(target=self._monitor, name="router-monitor",
                                                daemon=True)
        self._monitor_thread.start()

    @staticmethod
    def _replica_stream(svc: AdaCURService) -> Optional["torch.cuda.Stream"]:
        """A new stream for a service on a CUDA device, ordered after the
        work this thread has queued (the index's writes among it)."""
        dev = svc.device
        if dev.type != "cuda":
            return None
        dev = resolve_device(dev)
        stream = torch.cuda.Stream(device=dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        return stream

    # ------------------------------------------------------------------ API

    def submit(self, query_id: int, deadline_s: Optional[float] = None) -> Ticket:
        """Admit (or shed) a request; returns its ticket at once.

        ``deadline_s`` is a relative latency budget: past it the engine
        returns the anytime provisional top-k (``degraded``).  A full router
        (``queue_limit`` tickets in flight) resolves the ticket ``REJECTED``
        on the spot.
        """
        now = time.monotonic()
        deadline_t = now + deadline_s if deadline_s is not None else None
        with self._lock:
            seq = self._seq
            self._seq += 1
            tk = Ticket(seq, query_id, deadline_t, now)
            self.stats["submitted"] += 1
            if not self._running or len(self._live) >= self.queue_limit:
                self.stats["rejected"] += 1
                tk.resolve(REJECTED)
                return tk
            self._live[seq] = tk
            self._admitted += 1
            self.stats["admitted"] += 1
            swap = (self.plan is not None and self.swap_index_fn is not None
                    and self.plan.swap_due(self._admitted))
        if swap:
            self.swap_index(self.swap_index_fn())
        self._dispatch(tk)
        return tk

    def result(self, ticket: Ticket, timeout: Optional[float] = None) -> Optional[RouterResponse]:
        """Block for the ticket's terminal outcome (None only on timeout)."""
        ticket.done.wait(timeout)
        return ticket.outcome

    def swap_index(self, index) -> None:
        """Swap the live index on every replica.  Each service takes its own
        lock, so a batch in flight finishes under the old index first.  On
        a CUDA device every replica stream first waits for the work this
        thread queued (the new index's writes)."""
        with self._lock:
            self.stats["swaps"] += 1
            reps = list(self.replicas)
        streams = [rep.stream for rep in reps if rep.stream is not None]
        if streams:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(streams[0].device))
        for rep in reps:
            if rep.stream is not None:
                rep.stream.wait_event(ready)
            rep.service.swap_index(index)

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait until no tickets are in flight (True) or timeout (False)."""
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end:
            with self._lock:
                if not self._live:
                    return True
            time.sleep(0.002)
        with self._lock:
            return not self._live

    def close(self, timeout: float = 10.0) -> None:
        """Stop workers; any ticket still unresolved is resolved as an
        error: even shutdown may not lose a request.  Then every sharded
        replica's followers are stopped (a replica whose mesh a failure
        tore down has none left)."""
        self._running = False
        for rep in self.replicas:
            rep.q.put(_POISON)
        for rep in self.replicas:
            if rep.thread is not None:
                rep.thread.join(timeout)
        self._monitor_thread.join(timeout)
        with self._lock:
            leftovers = list(self._live.values())
        for tk in leftovers:
            if tk.resolve(ERROR, RetrievalResponse(query_id=tk.query_id, status="error",
                                                   error="router shutdown"), None):
                self._finish(tk)
        for rep in self.replicas:
            rep.service.stop_followers()

    # ------------------------------------------------------- dispatch plane

    def _pick(self, exclude: Sequence[int]) -> Optional[Replica]:
        with self._lock:
            candidates = [r for r in self.replicas if r.healthy and r.rid not in exclude]
            if not candidates:
                return None
            return min(candidates, key=lambda r: r.q.qsize())

    def _dispatch(self, tk: Ticket, exclude: Sequence[int] = (),
                  hedge: bool = False, retry: bool = False) -> None:
        rep = self._pick(exclude)
        if rep is None:
            # everyone we wanted to avoid is all there is: any healthy
            # replica beats a lost request
            rep = self._pick(())
        if rep is None:
            if tk.resolve(ERROR, RetrievalResponse(query_id=tk.query_id, status="error",
                                                   error="no healthy replicas"), None):
                self._finish(tk)
            return
        with tk.lock:
            if tk.done.is_set():
                return
            tk.replicas_tried.append(rep.rid)
            tk.dispatch_t = time.monotonic()
        with self._lock:
            if hedge:
                self.stats["hedges"] += 1
            if retry:
                self.stats["retries"] += 1
        rep.q.put(tk)

    def _finish(self, tk: Ticket) -> None:
        with self._lock:
            self._live.pop(tk.seq, None)
            out = tk.outcome
            if out is None:
                return
            if out.status == OK:
                self.stats["ok"] += 1
                if out.degraded:
                    self.stats["degraded"] += 1
            elif out.status == ERROR:
                self.stats["errors"] += 1

    def _attempt_failed(self, tk: Ticket, response: RetrievalResponse, rid: int) -> None:
        with tk.lock:
            if tk.done.is_set():
                return
            tk.failures += 1
            terminal = tk.failures > self.max_retries
            if not terminal:
                tk.retry_at = time.monotonic() + self.retry_backoff_s * tk.failures
        if terminal and tk.resolve(ERROR, response, rid):
            self._finish(tk)

    def _quarantine(self, rep: Replica, reason: str) -> None:
        with self._lock:
            if not rep.healthy:
                return
            rep.healthy = False
            self.stats["quarantines"] += 1
            self.quarantined.append(rep.rid)
        # drain its queue to healthy peers: nothing waits on a dead replica
        while True:
            try:
                tk = rep.q.get_nowait()
            except queue.Empty:
                break
            if tk is _POISON:
                rep.q.put(_POISON)
                break
            if not tk.resolved and not self._pending_elsewhere(tk, rep):
                self._dispatch(tk, exclude=[rep.rid])

    def _pending_elsewhere(self, tk: Ticket, rep: Replica) -> bool:
        """The ticket also waits on a healthy peer: it was hedged there and
        no attempt of it has failed, so each dispatch it had is pending.
        Draining it there again would queue it twice on that peer and
        score it twice in one batch."""
        with tk.lock:
            return tk.failures == 0 and any(
                rid != rep.rid and self.replicas[rid].healthy for rid in tk.replicas_tried)

    # --------------------------------------------------------- worker plane

    def _coalesce(self, rep: Replica, first: Ticket) -> List[Ticket]:
        batch = [first]
        while len(batch) < rep.service.max_batch:
            try:
                tk = rep.q.get_nowait()
            except queue.Empty:
                break
            if tk is _POISON:
                rep.q.put(_POISON)
                break
            batch.append(tk)
        return batch

    def _worker(self, rep: Replica) -> None:
        ctx = torch.cuda.stream(rep.stream) if rep.stream is not None else contextlib.nullcontext()
        with ctx:
            while self._running:
                try:
                    first = rep.q.get(timeout=0.02)
                except queue.Empty:
                    continue
                if first is _POISON:
                    break
                # duplicate suppression at the cheapest point: a ticket that
                # already resolved elsewhere (hedge winner) is dropped before
                # any CE pair is scored for it
                live = [t for t in self._coalesce(rep, first) if not t.resolved]
                if live:
                    self._serve_batch(rep, live)

    def _serve_batch(self, rep: Replica, live: List[Ticket]) -> None:
        t0 = time.monotonic()   # before any stall: the watchdog's observation
        # must include whatever is slowing this replica
        if self.plan is not None:
            stall = self.plan.sleep_s(rep.rid, [t.seq for t in live])
            if stall > 0:
                time.sleep(stall)
                # hedge winners answered during the stall are dropped before
                # any pair is scored for them: replicas share one card, so a
                # search nobody waits for would slow the peer that answered
                live = [t for t in live if not t.resolved]
        try:
            responses = rep.service.submit_and_flush(
                [RetrievalRequest(query_id=tk.query_id, deadline_t=tk.deadline_t)
                 for tk in live]) if live else []
        except Exception as e:  # noqa: BLE001 — the replica must survive
            responses = [RetrievalResponse(query_id=tk.query_id, status="error",
                                           error=f"{type(e).__name__}: {e}") for tk in live]
        dt = time.monotonic() - t0
        rep.step += 1
        rep.served += len(live)
        if rep.watchdog is not None:
            rep.watchdog.observe(rep.step, dt)
        all_err = bool(responses) and all(r.status == "error" for r in responses)
        rep.consecutive_errors = rep.consecutive_errors + 1 if all_err else 0
        for tk, resp in zip(live, responses):
            if resp.status == "error":
                self._attempt_failed(tk, resp, rep.rid)
            elif tk.resolve(OK, resp, rep.rid):
                self._finish(tk)
        for tk in live[len(responses):]:
            # a response went missing (service invariant breach): still
            # terminal, never leave a ticket hanging
            self._attempt_failed(tk, RetrievalResponse(
                query_id=tk.query_id, status="error",
                error="replica returned no response"), rep.rid)
        if rep.healthy and rep.consecutive_errors >= self.max_consecutive_errors:
            self._quarantine(rep, f"{rep.consecutive_errors} consecutive error batches")

    # -------------------------------------------------------------- monitor

    def _monitor(self) -> None:
        while self._running:
            now = time.monotonic()
            with self._lock:
                live = list(self._live.values())
            for tk in live:
                if tk.resolved:
                    continue
                with tk.lock:
                    due_retry = tk.retry_at is not None and now >= tk.retry_at
                    if due_retry:
                        tk.retry_at = None
                    due_hedge = (
                        not due_retry
                        and self.hedge_after_s is not None
                        and not tk.hedged
                        and tk.retry_at is None
                        and now - tk.dispatch_t >= self.hedge_after_s
                    )
                    if due_hedge:
                        tk.hedged = True
                if due_retry:
                    self._dispatch(tk, exclude=tk.replicas_tried, retry=True)
                elif due_hedge:
                    self._dispatch(tk, exclude=tk.replicas_tried, hedge=True)
            time.sleep(self.monitor_interval_s)


# ---------------------------------------------------------------------------
# replicas that are meshes led by another rank
# ---------------------------------------------------------------------------

_LINK_HEADER = 3           # (op, count, payload length); op 0 stop, 1 batch, 2 swap,
                           # 3 keep-alive
_META = ("query_id", "status", "degraded", "rounds_completed", "ce_calls",
         "measured_ce_calls", "cache_hits", "batch_id", "batch_row")


def _link_send(link, src: int, *tensors) -> None:
    """Broadcast host tensors from ``src`` over the link (empty ones are
    skipped: both ends know every shape from the header before them)."""
    for t in tensors:
        if t.numel():
            dist.broadcast(t, src=src, group=link)


def _link_recv(link, src: int, *shapes_dtypes):
    out = []
    for shape, dtype in shapes_dtypes:
        t = torch.empty(shape, dtype=dtype)
        if t.numel():
            dist.broadcast(t, src=src, group=link)
        out.append(t)
    return out


class RemoteReplica:
    """A sharded replica whose leader is another rank, as rank 0's router
    sees it: the service interface the router calls (``max_batch``,
    ``device``, ``submit_and_flush``, ``swap_index``, ``stop_followers``,
    ``batch_log``), carried over ``link``, the two-rank group {0, leader}
    (``launch.mesh.make_replica_meshes``), to :func:`serve_remote` on the
    leader, which runs its ``AdaCURService``.

    The traffic is host tensors through broadcasts on the link (rank 0
    sends a request list, the leader answers with the responses), one
    operation at a time under a lock, so the router's order of batches and
    swaps is the order the replica runs them in.  A deadline travels as
    the budget left when the list is sent.  The link is never torn down:
    a failure inside the replica comes back as error responses, and the
    router quarantines the replica as it would any other.  The leader waits
    for the next operation on the link as long as traffic is idle: a
    :class:`~repro_torch.launch.serve.KeepAlive` thread sends a keep-alive
    header (op 3, which :func:`serve_remote` skips) whenever nothing went
    out for a sixth of the link's timeout."""

    def __init__(self, link, leader: int, max_batch: int):
        self.link = link
        self.leader = leader
        self.max_batch = max_batch
        self.device = torch.device("cpu")     # the link's tensors; the replica's are its own
        self.batch_log: List[dict] = []
        self._lock = threading.Lock()
        self._stopped = False
        self.keepalives = 0                     # keep-alive headers sent
        self._last_sent = time.monotonic()
        self._keepalive = KeepAlive(self, keepalive_interval_s(link))

    def _header(self, op: int, count: int = 0, length: int = 0) -> None:
        _link_send(self.link, 0, torch.tensor([op, count, length], dtype=torch.int64))
        self._last_sent = time.monotonic()

    def _keepalive_tick(self) -> bool:
        """A keep-alive header once nothing went out for the interval; False
        once stopped.  A busy link (its lock held) carries headers of its
        own."""
        if not self._lock.acquire(blocking=False):
            return True
        try:
            if self._stopped:
                return False
            if time.monotonic() - self._last_sent >= self._keepalive.interval_s:
                self._header(3)
                self.keepalives += 1
            return True
        finally:
            self._lock.release()

    def submit_and_flush(self, requests: List[RetrievalRequest]) -> List[RetrievalResponse]:
        with self._lock:
            now = time.monotonic()
            left = [float("nan") if r.deadline_t is None else r.deadline_t - now
                    for r in requests]
            self._header(1, len(requests))
            _link_send(self.link, 0, torch.tensor(
                [[r.query_id, b] for r, b in zip(requests, left)], dtype=torch.float64))
            (hdr,) = _link_recv(self.link, self.leader, ((_LINK_HEADER,), torch.int64))
            n, k, length = hdr.tolist()
            meta, ids, scores, text = _link_recv(
                self.link, self.leader, ((n, len(_META)), torch.int64), ((n, k), torch.int64),
                ((n, k), torch.float32), ((length,), torch.uint8))
            errors = json.loads(bytes(text.tolist()).decode()) if length else [None] * n
            done = time.monotonic()
            out = []
            for i, req in enumerate(requests[:n]):
                m = dict(zip(_META, meta[i].tolist()))
                ok = m["status"] == 0
                opt = {f: (None if m[f] < 0 else m[f])
                       for f in ("rounds_completed", "measured_ce_calls", "cache_hits",
                                 "batch_id", "batch_row")}
                out.append(RetrievalResponse(
                    query_id=req.query_id, item_ids=ids[i].numpy() if ok else None,
                    scores=scores[i].numpy() if ok else None,
                    latency_s=done - req.arrival_t, ce_calls=m["ce_calls"],
                    status="ok" if ok else "error", degraded=bool(m["degraded"]),
                    error=errors[i], **opt))
            return out

    def swap_index(self, index=None) -> List[RetrievalResponse]:
        """The leader swaps to the index its ranks staged
        (``AdaCURService.stage_index``); ``index`` must be None (it lives
        on the replica's ranks, not here)."""
        if index is not None:
            raise ValueError("a remote replica swaps to the index its own ranks staged: "
                             "pass None")
        with self._lock:
            self._header(2)
        return []

    def stop_followers(self) -> None:
        """End the leader's :func:`serve_remote` (which stops its own
        followers)."""
        self._keepalive.stop()
        with self._lock:
            if not self._stopped:
                self._stopped = True
                self._header(0)


def serve_remote(service: AdaCURService, link) -> int:
    """The replica leader's loop: run each operation rank 0's
    :class:`RemoteReplica` sends over ``link`` on ``service`` (a sharded
    service over the replica's group), until it stops; then stop the
    service's followers.  Returns the number of request lists served."""
    n = 0
    me = dist.get_rank()
    while True:
        (hdr,) = _link_recv(link, 0, ((_LINK_HEADER,), torch.int64))
        op, count, _ = hdr.tolist()
        if op == 0:
            service.stop_followers()
            return n
        if op == 2:
            service.swap_index(None)
            continue
        if op == 3:          # rank 0's keep-alive
            continue
        (reqs,) = _link_recv(link, 0, ((count, 2), torch.float64))
        now = time.monotonic()
        responses = service.submit_and_flush([
            RetrievalRequest(query_id=int(q), arrival_t=now,
                             deadline_t=None if b != b else now + float(b))
            for q, b in reqs.tolist()])
        k = max((len(r.item_ids) for r in responses if r.item_ids is not None), default=0)
        meta = torch.tensor([[r.query_id, int(r.status != "ok"), int(r.degraded),
                              *(-1 if v is None else int(v) for v in (
                                  r.rounds_completed, r.ce_calls, r.measured_ce_calls,
                                  r.cache_hits, r.batch_id, r.batch_row))]
                             for r in responses], dtype=torch.int64).reshape(-1, len(_META))
        ids = torch.zeros((len(responses), k), dtype=torch.int64)
        scores = torch.zeros((len(responses), k), dtype=torch.float32)
        for i, r in enumerate(responses):
            if r.item_ids is not None:
                ids[i] = torch.as_tensor(r.item_ids, dtype=torch.int64)
                scores[i] = torch.as_tensor(r.scores, dtype=torch.float32)
        errors = [r.error for r in responses]
        text = (torch.tensor(list(json.dumps(errors).encode()), dtype=torch.uint8)
                if any(errors) else torch.zeros(0, dtype=torch.uint8))
        _link_send(link, me, torch.tensor([len(responses), k, text.numel()], dtype=torch.int64),
                   meta, ids, scores, text)
        n += 1
