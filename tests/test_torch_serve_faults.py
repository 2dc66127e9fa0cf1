"""The port's serving tier under injected faults (the chaos suite of
``tests/test_serve_faults.py``, ported), then the tier held live against
the JAX package on the CPU.

Every injected failure must end in exactly one terminal response per
request (results, degraded results, error or rejection), with the replica
loop, the router and the index still live afterwards.  Failure modes
(deterministic, via ``repro_torch.launch.faults.FaultPlan``):
deadline-degraded anytime answers (and their prefix consistency against an
explicit shorter run), scorer exceptions contained at the flush boundary,
an index swap racing live submissions from other threads, hedged duplicate
suppression, error- and straggler-driven quarantine with queue drain, and
admission-control rejection ordering.

Against the reference (same numpy inputs, bars of ``tests/test_engine.py``
where results are compared): (a) one search calls the port's scorer as
many times, with the same shapes, as the reference calls its
``FaultyScorer``, so ``ScorerFault(call_k=k)`` fails the same round in
both; (b) ``StragglerWatchdog``, ``HeartbeatMonitor`` and ``elastic_plan``
give the reference's results; (c) ``FaultPlan`` agrees on a seeded
schedule; (d) a one-replica ``Router`` over deterministic services returns
the reference router's ids (top-k overlap >= 0.99, scores within 1e-5).
Then the launch counters count every launch from four threads.

The module runs under a faulthandler watchdog (``SERVE_WATCHDOG_S``): a
deadlocked router or replica thread dumps every stack and ends the run
instead of hanging it.
"""

import logging
import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AdaCURConfig as JConfig  # noqa: E402
from repro.core.engine import AdaCURRetriever as JRetriever  # noqa: E402
from repro.core.index import AnchorIndex as JIndex  # noqa: E402
from repro.core.scorer import TabulatedScorer as JTabulated  # noqa: E402
from repro.distributed import fault_tolerance as jft  # noqa: E402
from repro.launch import faults as jfaults  # noqa: E402
from repro.launch.router import Router as JRouter  # noqa: E402
from repro.launch.serve import AdaCURService as JService  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs.base import AdaCURConfig  # noqa: E402
from repro_torch.core.engine import AdaCURRetriever, ce_call_plan  # noqa: E402
from repro_torch.core.index import AnchorIndex  # noqa: E402
from repro_torch.core.scorer import TabulatedScorer  # noqa: E402
from repro_torch.distributed import fault_tolerance as tft  # noqa: E402
from repro_torch.launch import faults as tfaults  # noqa: E402
from repro_torch.launch.faults import (  # noqa: E402
    FaultInjectedError,
    FaultPlan,
    FaultyScorer,
    ScorerFault,
    SleepFault,
    SwapFault,
)
from repro_torch.launch.router import Router  # noqa: E402
from repro_torch.launch.serve import AdaCURService, RetrievalRequest  # noqa: E402
from repro_torch.testing import topk_overlap  # noqa: E402

N_Q, N_ITEMS = 60, 100
CFG_KW = dict(k_anchor=4, n_rounds=4, budget_ce=12, k_retrieve=8, loop_mode="fori")
CFG = AdaCURConfig(**CFG_KW)


@pytest.fixture(autouse=True, scope="module")
def _watchdog():
    import faulthandler

    watchdog_s = float(os.environ.get("SERVE_WATCHDOG_S", "480"))
    faulthandler.dump_traceback_later(watchdog_s, exit=True)
    # the reference's injected faults log from inside its callback machinery
    logging.getLogger("jax._src.callback").setLevel(logging.CRITICAL)
    yield
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture(scope="module")
def m():
    rng = np.random.default_rng(0)
    return rng.standard_normal((N_Q, N_ITEMS)).astype(np.float32)


def _ids(lo, hi):
    return torch.arange(lo, hi, dtype=torch.int32)


def _service(m, *, plan=None, replica=None, item_offset=0, deterministic=False,
             max_batch=None, batch_buckets=None, record_pairs=False):
    if max_batch is None:
        max_batch = max(batch_buckets) if batch_buckets else 4
    wide = np.zeros((N_Q, item_offset + N_ITEMS), dtype=np.float32)
    wide[:, item_offset:] = m
    scorer = TabulatedScorer(wide, record_pairs=record_pairs)
    if plan is not None:
        scorer = FaultyScorer(scorer, plan, replica=replica)
    index = AnchorIndex.from_r_anc(torch.from_numpy(m[:40].copy()),
                                   item_ids=_ids(item_offset, item_offset + N_ITEMS))
    retriever = AdaCURRetriever.from_index(index, scorer, CFG, anytime=True)
    return AdaCURService(retriever=retriever, max_batch=max_batch, max_wait_s=60.0,
                         batch_buckets=batch_buckets, deterministic=deterministic)


def _two_namespaces(m):
    """A scorer matrix that answers both the 1000.. and the 2000.. ids."""
    wide = np.zeros((N_Q, 2000 + N_ITEMS), dtype=np.float32)
    wide[:, 1000:1000 + N_ITEMS] = m
    wide[:, 2000:] = m
    return torch.from_numpy(wide)


class TestAnytimeDeadline:
    def test_degraded_response_is_prefix_consistent(self, m):
        """An expired budget returns the provisional top-k of the rounds
        completed, and that answer is exactly the answer of an explicit
        ``n_rounds=rounds_completed`` run (same key, same batch shape)."""
        svc = _service(m, deterministic=True, batch_buckets=[1])
        (r,) = svc.submit(RetrievalRequest(
            query_id=45, deadline_t=time.monotonic() - 1.0)) or svc.flush()
        assert r.status == "ok" and r.degraded
        assert r.rounds_completed == 1          # round 0 always completes
        assert r.measured_ce_calls == ce_call_plan(CFG, 1)
        ref = svc.retriever.search(torch.tensor([45]), svc._key, n_rounds=r.rounds_completed)
        ref_ids = svc.index.gather_item_ids(ref.topk_idx).numpy()[0]
        np.testing.assert_array_equal(r.item_ids, ref_ids)
        np.testing.assert_array_equal(r.scores, ref.topk_scores[0].numpy())

    def test_generous_deadline_serves_full_search(self, m):
        svc = _service(m, deterministic=True, batch_buckets=[1])
        (r,) = svc.submit(RetrievalRequest(
            query_id=45, deadline_t=time.monotonic() + 60.0)) or svc.flush()
        assert not r.degraded and r.rounds_completed == CFG.n_rounds
        assert r.measured_ce_calls == ce_call_plan(CFG)

    def test_deadline_requires_anytime_retriever(self, m):
        scorer = TabulatedScorer(m)
        index = AnchorIndex.from_r_anc(torch.from_numpy(m[:40].copy()))
        retr = AdaCURRetriever.from_index(index, scorer, CFG)  # not anytime
        with pytest.raises(ValueError, match="anytime"):
            retr.search(torch.tensor([3]), deadline_t=time.monotonic())


class TestFlushErrorBoundary:
    def test_scorer_exception_fails_batch_not_loop(self, m):
        """A scorer raising on call k fails exactly the in-flight batch
        (per-request error responses); the queue and the engine stay
        serviceable for the next batch."""
        plan = FaultPlan(scorer_faults=[ScorerFault(call_k=1)])
        svc = _service(m, plan=plan, batch_buckets=[1, 2, 4])
        svc.submit(RetrievalRequest(query_id=3))
        svc.submit(RetrievalRequest(query_id=7))
        out = svc.flush()
        assert [r.query_id for r in out] == [3, 7]
        assert all(r.status == "error" for r in out)
        assert all("FaultInjectedError" in r.error for r in out)
        assert all(r.item_ids is None for r in out)
        # the very next batch (call counter past the fault) serves cleanly
        svc.submit(RetrievalRequest(query_id=3))
        (ok,) = svc.flush()
        assert ok.status == "ok" and ok.error is None
        assert (0 <= ok.item_ids).all() and (ok.item_ids < N_ITEMS).all()

    def test_fault_raises_at_exact_call(self, m):
        plan = FaultPlan(scorer_faults=[ScorerFault(call_k=3)])
        scorer = FaultyScorer(TabulatedScorer(m), plan)
        q, idx = torch.tensor([0]), torch.tensor([[1, 2]])
        scorer(q, idx)
        scorer(q, idx)
        with pytest.raises(FaultInjectedError):
            scorer(q, idx)
        # stats stayed on the inner scorer and counted only served calls
        assert scorer.stats.ce_calls == 4


class TestSwapUnderLiveSubmissions:
    def test_concurrent_swap_and_submit(self, m):
        """submit()/flush() from worker threads racing swap_index() from the
        main thread: every response's ids come wholly from one index's
        namespace, and responses drained by the swap are answered against
        the admitting (old) index."""
        svc = _service(m, item_offset=1000, max_batch=2, batch_buckets=[1, 2])
        svc._scorer.matrix = _two_namespaces(m)
        new_index = AnchorIndex.from_r_anc(torch.from_numpy(m[:40].copy()),
                                           item_ids=_ids(2000, 2000 + N_ITEMS))
        svc.retriever.search(torch.tensor([0, 1]))

        responses, stop = [], threading.Event()
        out_lock = threading.Lock()

        def submitter(seed):
            rng = np.random.default_rng(seed)
            while not stop.is_set():
                got = svc.submit(RetrievalRequest(query_id=int(rng.integers(0, N_Q)))) or []
                got += svc.flush()
                with out_lock:
                    responses.extend(got)

        threads = [threading.Thread(target=submitter, args=(s,)) for s in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.1)
        drained = svc.swap_index(new_index)
        time.sleep(0.1)
        stop.set()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        responses.extend(svc.flush())

        for r in drained:
            assert (r.item_ids >= 1000).all() and (r.item_ids < 2000).all()
        assert responses, "submitter threads served nothing"
        for r in responses:
            assert r.status == "ok"
            old = (r.item_ids >= 1000) & (r.item_ids < 2000)
            new = r.item_ids >= 2000
            assert old.all() or new.all(), "mixed-namespace response"
        # traffic after the swap point lands on the new index
        svc.submit(RetrievalRequest(query_id=5))
        (after,) = svc.flush()
        assert (after.item_ids >= 2000).all()


def _router(m, n_replicas=2, plan=None, record_pairs=False, **kw):
    services = [_service(m, plan=plan, replica=rid, batch_buckets=[1, 2, 4],
                         record_pairs=record_pairs)
                for rid in range(n_replicas)]
    return Router(services, plan=plan, **kw)


def _warm(router):
    """Run every replica's batch buckets once before the timing-sensitive
    phases, as the reference's chaos suite compiles them."""
    for rep in router.replicas:
        for b in rep.service.batch_buckets:
            rep.service.retriever.search(torch.arange(b))


class TestRouterChaos:
    def test_hedged_pair_yields_exactly_one_response(self, m):
        """Replica 0 stalls every batch; hedging re-dispatches to replica 1.
        Each ticket resolves exactly once (CAS), and the winning attempt
        scored each of its CE pairs at most once."""
        plan = FaultPlan(sleep_faults=[SleepFault(replica=0, seconds=0.3)])
        router = _router(m, plan=plan, queue_limit=64, hedge_after_s=0.05, record_pairs=True)
        try:
            _warm(router)
            qids = list(range(10, 18))           # distinct per ticket
            tickets = [router.submit(q) for q in qids]
            outs = [router.result(t, timeout=120) for t in tickets]
            assert all(o is not None for o in outs), "lost request"
            assert all(o.status == "ok" for o in outs)
            assert router.stats["hedges"] >= 1
            for t, o in zip(tickets, outs):
                # one terminal outcome; a replica never serves the same
                # ticket twice (hedge/retry dispatch excludes replicas
                # already tried)
                assert o.attempts <= 2           # original + at most 1 hedge
                assert len(t.replicas_tried) == len(set(t.replicas_tried))
            # within every scorer call, a request's pair rows are
            # duplicate-free on both replicas
            for rep in router.replicas:
                for qarr, iarr in rep.service._scorer.call_log:
                    for qr, row in zip(qarr, iarr):
                        assert len(row) == len(set(row.tolist())), (
                            "duplicate pair inside one scorer call")
        finally:
            router.close()

    def test_error_quarantine_drains_to_peers(self, m):
        """A replica whose every batch errors is quarantined after
        ``max_consecutive_errors`` and its queue drained: every request
        still ends OK via the healthy peer."""
        plan = FaultPlan(scorer_faults=[ScorerFault(call_k=k, replica=0) for k in range(1, 500)])
        router = _router(m, plan=plan, queue_limit=64, max_retries=2, max_consecutive_errors=2)
        try:
            tickets = [router.submit(i % N_Q) for i in range(16)]
            outs = [router.result(t, timeout=120) for t in tickets]
            assert all(o is not None for o in outs), "lost request"
            assert all(o.status == "ok" for o in outs)
            assert router.quarantined == [0]
            assert not router.replicas[0].healthy
            assert router.replicas[1].healthy
            # post-quarantine traffic routes around the dead replica
            t = router.submit(9)
            out = router.result(t, timeout=120)
            assert out.status == "ok" and out.replica == 1
        finally:
            router.close()

    def test_straggler_watchdog_quarantines_slow_replica(self, m):
        """With the fleet baseline warmed by the healthy peer, a
        persistently slow replica is flagged against the shared median and
        quarantined after ``patience`` straggler batches."""
        # patience=1: hedging steals the stalled replica's repeat traffic.
        # Margins: a warm CPU batch takes milliseconds, the flag level is
        # 8 x 0.1 s = 0.8 s and the injected stall 1 s
        plan = FaultPlan(sleep_faults=[SleepFault(replica=0, seconds=1.0)])
        router = _router(m, plan=plan, queue_limit=64, hedge_after_s=0.05,
                         watchdog_threshold=8.0, watchdog_patience=1)
        try:
            _warm(router)
            # the shared deque: replica 0 is judged against its peers'
            # median, not its own stalled history
            router.replicas[1].watchdog.window.extend([0.1] * 8)
            tickets = [router.submit(i % N_Q) for i in range(12)]
            outs = [router.result(t, timeout=120) for t in tickets]
            assert all(o is not None and o.status == "ok" for o in outs)
            # hedging answers before the stalled batch completes: wait for
            # that batch to land and be flagged
            t_end = time.monotonic() + 30.0
            while 0 not in router.quarantined and time.monotonic() < t_end:
                time.sleep(0.05)
            assert 0 in router.quarantined
            assert router.replicas[0].watchdog.window is router.replicas[1].watchdog.window
            # the quarantine drain sends no ticket back to a replica that
            # already holds it (its hedge)
            for t in tickets:
                assert len(t.replicas_tried) == len(set(t.replicas_tried))
        finally:
            router.close()

    def test_admission_rejection_ordering(self, m):
        """Load shedding is immediate and explicit: once ``queue_limit``
        tickets are in flight, the next submit resolves REJECTED before any
        in-flight ticket completes."""
        plan = FaultPlan(sleep_faults=[SleepFault(replica=0, seconds=0.5)])
        router = _router(m, n_replicas=1, plan=plan, queue_limit=2)
        try:
            _warm(router)
            admitted = [router.submit(i) for i in range(2)]
            shed = [router.submit(i) for i in range(2, 5)]
            for t in shed:
                assert t.resolved and t.outcome.status == "rejected"
                assert t.outcome.attempts == 0
            assert not any(t.resolved for t in admitted)
            outs = [router.result(t, timeout=120) for t in admitted]
            assert all(o is not None and o.status == "ok" for o in outs)
            assert router.stats["rejected"] == 3
            assert router.stats["admitted"] == 2
        finally:
            router.close()

    def test_midflight_swap_preserves_namespace_consistency(self, m):
        """A FaultPlan-scheduled swap at admission n: every response's ids
        are wholly from one index namespace and nothing is lost."""
        new_index = AnchorIndex.from_r_anc(torch.from_numpy(m[:40].copy()),
                                           item_ids=_ids(2000, 2000 + N_ITEMS))
        plan = FaultPlan(swap_faults=[SwapFault(at_seq=6)])
        services = []
        for _ in range(2):
            index = AnchorIndex.from_r_anc(torch.from_numpy(m[:40].copy()),
                                           item_ids=_ids(1000, 1000 + N_ITEMS))
            retriever = AdaCURRetriever.from_index(index, TabulatedScorer(_two_namespaces(m)),
                                                   CFG, anytime=True)
            services.append(AdaCURService(retriever=retriever, max_batch=4, max_wait_s=60.0,
                                          batch_buckets=[1, 2, 4]))
        router = Router(services, plan=plan, queue_limit=64, swap_index_fn=lambda: new_index)
        try:
            tickets = [router.submit(i % N_Q) for i in range(12)]
            outs = [router.result(t, timeout=120) for t in tickets]
            assert all(o is not None for o in outs), "lost request"
            assert all(o.status == "ok" for o in outs)
            assert router.stats["swaps"] == 1
            seen_new = False
            for o in outs:
                ids = o.response.item_ids
                old = ((ids >= 1000) & (ids < 2000)).all()
                new = (ids >= 2000).all()
                assert old or new, "mixed-namespace response"
                seen_new = seen_new or new
            assert seen_new, "swap never took effect"
        finally:
            router.close()

    def test_close_resolves_stragglers(self, m):
        """Shutdown with tickets still in flight: close() resolves them as
        errors, so even teardown cannot lose a request."""
        plan = FaultPlan(sleep_faults=[SleepFault(replica=0, seconds=2.0)])
        router = _router(m, n_replicas=1, plan=plan, queue_limit=8)
        _warm(router)
        tickets = [router.submit(i) for i in range(3)]
        router.close(timeout=0.2)
        for t in tickets:
            out = router.result(t, timeout=120)
            assert out is not None
            assert out.status in ("ok", "error")


# ---------------------------------------------------------------------------
# live parity against the reference
# ---------------------------------------------------------------------------


def test_scorer_is_called_as_the_reference_calls_its_callback(m):
    """(a) One search at the chaos CFG calls the port's scorer as many
    times, with the same (B, n) shapes, as the reference engine calls its
    ``FaultyScorer``; so ``ScorerFault(call_k=k)`` fails the same round in
    both packages: each raises at call k, after k - 1 scored calls."""
    qids = np.arange(41, 45)
    j_inner = JTabulated(m, record_pairs=True)
    j_scorer = jfaults.FaultyScorer(j_inner)
    j_ret = JRetriever.from_index(JIndex.from_r_anc(jnp.asarray(m[:40])), j_scorer,
                                  JConfig(**CFG_KW), anytime=True)
    t_inner = TabulatedScorer(m, record_pairs=True)
    t_scorer = FaultyScorer(t_inner)
    t_ret = AdaCURRetriever.from_index(AnchorIndex.from_r_anc(torch.from_numpy(m[:40].copy())),
                                       t_scorer, CFG, anytime=True)
    jax.block_until_ready(j_ret.search(jnp.asarray(qids), jax.random.PRNGKey(0)).topk_idx)
    t_ret.search(torch.from_numpy(qids))
    shapes = [idx.shape for _, idx in j_inner.call_log]
    assert j_scorer.calls == t_scorer.calls == len(shapes) == CFG.n_rounds + 1
    assert [idx.shape for _, idx in t_inner.call_log] == shapes

    for k in range(1, len(shapes) + 1):
        for pkg, inner, scorer, run in (
                (jfaults, j_inner, j_scorer, lambda: jax.block_until_ready(
                    j_ret.search(jnp.asarray(qids), jax.random.PRNGKey(0)).topk_idx)),
                (tfaults, t_inner, t_scorer, lambda: t_ret.search(torch.from_numpy(qids)))):
            inner.reset_stats()
            scorer.calls = 0
            scorer.plan = pkg.FaultPlan([pkg.ScorerFault(call_k=k)])
            with pytest.raises(Exception) as err:
                run()
            assert "injected scorer fault" in str(err.value)
            assert scorer.calls == k and len(inner.call_log) == k - 1
        jax.effects_barrier()


def _watchdog_trace(ft, seconds, threshold, patience):
    """Two watchdogs over one shared baseline fed the same step times;
    returns everything they report."""
    fired = []
    base = ft.StragglerWatchdog.shared_baseline(window=10)
    dogs = [ft.StragglerWatchdog(threshold=threshold, patience=patience, baseline=base,
                                 on_straggler=lambda st, i=i: fired.append((i, st.step)))
            for i in range(2)]
    solo = ft.StragglerWatchdog(threshold=threshold, window=7, patience=patience)
    for step, s in enumerate(seconds):
        dogs[step % 2].observe(step, s)
        solo.observe(step, s)
    hist = [[(h.step, h.seconds, h.straggler) for h in d.history] for d in (*dogs, solo)]
    trace = dict(fired=fired, hist=hist, window=list(base), solo_window=list(solo.window),
                 consecutive=[d.consecutive for d in (*dogs, solo)])
    # timed() observes a wall time, so only its result and its one step compare
    trace.update(timed=solo.timed(len(seconds), lambda x: x + 1, 41),
                 timed_step=solo.history[-1].step)
    return trace


def test_fault_tolerance_matches_reference():
    """(b) StragglerWatchdog (shared and own baseline), HeartbeatMonitor and
    elastic_plan fed the same inputs give the reference's results."""
    rng = np.random.default_rng(5)
    seconds = rng.uniform(0.05, 0.1, 80)
    seconds[rng.choice(80, 20, replace=False)] *= rng.uniform(2.0, 6.0, 20)
    seconds = seconds.tolist()
    for threshold, patience in ((2.0, 1), (2.0, 3), (3.0, 2)):
        ref = _watchdog_trace(jft, seconds, threshold, patience)
        port = _watchdog_trace(tft, seconds, threshold, patience)
        assert port == ref
        assert ref["fired"], "the schedule never tripped a watchdog"
    beats = [(f"h{int(rng.integers(0, 6))}", float(t)) for t in np.sort(rng.uniform(0, 100, 40))]
    mons = (jft.HeartbeatMonitor(timeout=7.5), tft.HeartbeatMonitor(timeout=7.5))
    for host, t in beats:
        for mon in mons:
            mon.beat(host, now=t)
        assert mons[1].dead_hosts(now=t + 5.0) == mons[0].dead_hosts(now=t + 5.0)
        assert mons[1].healthy_count(now=t + 9.0) == mons[0].healthy_count(now=t + 9.0)
    assert mons[1].last_seen == mons[0].last_seen
    for n in range(0, 600):
        assert tft.elastic_plan(n) == jft.elastic_plan(n)
    assert tft.elastic_plan(10, ((3, 3), (2,))) == jft.elastic_plan(10, ((3, 3), (2,)))


def test_fault_plan_matches_reference():
    """(c) sleep_s, swap_due and scorer_should_raise agree on a seeded
    schedule (swap_due is one-shot state: both advance in lockstep)."""
    rng = np.random.default_rng(11)
    replicas = [None, 0, 1, 2]
    scorer = [(int(rng.integers(1, 40)), replicas[int(rng.integers(0, 4))]) for _ in range(25)]
    sleep = [(int(rng.integers(0, 3)), float(rng.uniform(0.01, 1.0)),
              None if rng.random() < 0.3 else int(rng.integers(0, 60))) for _ in range(15)]
    swaps = [int(s) for s in rng.integers(1, 60, 4)]
    plans = [pkg.FaultPlan(scorer_faults=[pkg.ScorerFault(k, r) for k, r in scorer],
                           sleep_faults=[pkg.SleepFault(r, s, q) for r, s, q in sleep],
                           swap_faults=[pkg.SwapFault(a) for a in swaps])
             for pkg in (jfaults, tfaults)]
    for k in range(0, 45):
        for r in (0, 1, 2, 3, None):
            assert plans[1].scorer_should_raise(k, r) == plans[0].scorer_should_raise(k, r)
    for r in range(4):
        for _ in range(30):
            seqs = rng.integers(0, 60, int(rng.integers(0, 6))).tolist()
            assert plans[1].sleep_s(r, seqs) == plans[0].sleep_s(r, seqs)
    fired = []
    for admitted in range(0, 70):
        due = plans[0].swap_due(admitted)
        assert plans[1].swap_due(admitted) == due
        fired.append(due)
    assert 0 < sum(fired) <= len(swaps)
    assert [f.at_seq for f in plans[1]._swaps_fired] == [f.at_seq for f in plans[0]._swaps_fired]


def test_one_replica_router_returns_the_reference_routers_ids(m):
    """(d) A one-replica Router over a deterministic service with bucket
    [1] answers 16 queries with the reference router's ids."""
    qids = [int(q) for q in np.random.default_rng(3).integers(0, N_Q, 16)]
    j_index = JIndex.from_r_anc(jnp.asarray(m[:40]), item_ids=jnp.arange(N_ITEMS))
    j_svc = JService(retriever=JRetriever.from_index(j_index, JTabulated(m), JConfig(**CFG_KW),
                                                     anytime=True),
                     max_batch=1, max_wait_s=60.0, batch_buckets=[1], deterministic=True)
    t_svc = _service(m, deterministic=True, batch_buckets=[1])
    outs = []
    for router in (JRouter([j_svc], queue_limit=64), Router([t_svc], queue_limit=64)):
        try:
            tickets = [router.submit(q) for q in qids]
            outs.append([router.result(t, timeout=120) for t in tickets])
        finally:
            router.close()
    assert all(o is not None and o.status == "ok" for out in outs for o in out)
    j_ids = np.stack([o.response.item_ids for o in outs[0]])
    t_ids = np.stack([o.response.item_ids for o in outs[1]])
    assert topk_overlap(t_ids, j_ids) >= 0.99
    same = t_ids == j_ids
    np.testing.assert_allclose(np.stack([o.response.scores for o in outs[1]])[same],
                               np.stack([o.response.scores for o in outs[0]])[same],
                               atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the port router's three departures from the reference, each shown on both
# ---------------------------------------------------------------------------


def _fleet(pkg, m, n_replicas, plan=None, record_pairs=False, **kw):
    """``n_replicas`` services over the chaos domain (buckets [1, 2, 4];
    buckets 1 and 2, the ones these tests fire, searched once; scorer
    stats cleared) behind a Router of ``pkg``: ``jfaults`` for the
    reference, ``tfaults`` for the port."""
    if pkg is tfaults:
        router = _router(m, n_replicas, plan=plan, record_pairs=record_pairs, **kw)
        _warm(router)
        for rep in router.replicas:
            rep.service._scorer.reset_stats()
        return router
    services = []
    for _ in range(n_replicas):
        index = JIndex.from_r_anc(jnp.asarray(m[:40]), item_ids=jnp.arange(N_ITEMS))
        ret = JRetriever.from_index(index, JTabulated(m, record_pairs=record_pairs),
                                    JConfig(**CFG_KW), anytime=True)
        for b in (1, 2):
            jax.block_until_ready(ret.search(jnp.arange(b), jax.random.PRNGKey(0)).topk_idx)
        ret.score_fn.reset_stats()
        services.append(JService(retriever=ret, max_batch=4, max_wait_s=60.0,
                                 batch_buckets=[1, 2, 4]))
    return JRouter(services, plan=plan, **kw)


def _hook_submit(svc, before=None, after=None):
    """Wrap one service's ``submit`` (both routers' workers reach it):
    ``before(req)`` runs ahead of the real submit, ``after(req)`` behind."""
    inner = svc.submit

    def submit(req):
        if before is not None:
            before(req)
        out = inner(req)
        if after is not None:
            after(req)
        return out

    svc.submit = submit


def test_swap_between_submit_and_flush_misroutes_responses_in_the_reference_only(m):
    """The reference worker submits a batch's requests one at a time and
    then flushes, with the service's lock free in between.  A swap_index
    there drains the requests queued so far to the swapping thread; the
    worker's flush answers only the rest and zips them onto the batch's
    first tickets, so a ticket resolves ok with another query's response.
    The port's worker queues and flushes under the service's lock
    (``AdaCURService.submit_and_flush``): the swap waits for the batch."""
    def run(pkg):
        router = _fleet(pkg, m, 1, queue_limit=8)
        svc = router.replicas[0].service
        entered, gate, swapper = threading.Event(), threading.Event(), []

        def hold_first(req):
            # the first batch is query 10 alone; 11 and 12 queue behind it
            if req.query_id == 10:
                entered.set()
                gate.wait(30)

        def swap_after_11(req):
            if req.query_id == 11 and not swapper:
                swapper.append(threading.Thread(target=router.swap_index, args=(svc.index,)))
                swapper[0].start()
                swapper[0].join(timeout=0.5)     # the reference's swap is done by then

        _hook_submit(svc, hold_first, swap_after_11)
        try:
            tickets = [router.submit(10)]
            assert entered.wait(30)
            tickets += [router.submit(q) for q in (11, 12)]
            gate.set()
            outs = [router.result(t, timeout=60) for t in tickets]
            swapper[0].join(timeout=60)
        finally:
            router.close()
        assert all(o is not None and o.status == "ok" for o in outs)
        assert router.stats["swaps"] == 1
        return [o.response.query_id for o in outs], router.stats

    ref_answered, ref_stats = run(jfaults)
    port_answered, port_stats = run(tfaults)
    assert ref_answered[1] == 12, "the reference's ticket 11 got query 12's response"
    assert ref_stats["retries"] >= 1      # ticket 12 went unanswered, then was retried
    assert port_answered == [10, 11, 12]
    assert port_stats["retries"] == 0


def test_quarantine_drain_queues_a_hedged_ticket_twice_in_the_reference_only(m):
    """A ticket waits on replica 0's queue and its hedge on replica 1's.
    Quarantining replica 0, the reference drains the ticket to replica 1
    again, which then holds it twice (one batch scores it twice); the port
    leaves it where its hedge waits, and it still ends ok there."""
    def run(pkg):
        router = _fleet(pkg, m, 2, queue_limit=8)
        entered = [threading.Event(), threading.Event()]
        gate = threading.Event()
        for rid, rep in enumerate(router.replicas):
            def hold_first(req, rid=rid):
                if not entered[rid].is_set():
                    entered[rid].set()
                    gate.wait(30)
            _hook_submit(rep.service, hold_first)
        try:
            x = router.submit(10)
            assert entered[0].wait(30)            # replica 0 serves x
            y = router.submit(11)                 # both queues empty: replica 0's
            z = router.submit(12)                 # replica 1's, which serves it
            assert entered[1].wait(30)
            assert y.replicas_tried == [0] and z.replicas_tried == [1]
            router._dispatch(y, exclude=y.replicas_tried, hedge=True)
            router._quarantine(router.replicas[0], "test")
            on_peer = list(router.replicas[1].q.queue).count(y)
            gate.set()
            outs = [router.result(t, timeout=60) for t in (x, y, z)]
        finally:
            router.close()
        assert all(o is not None and o.status == "ok" for o in outs)
        assert outs[1].replica == 1
        return on_peer

    assert run(jfaults) == 2
    assert run(tfaults) == 1


def test_stalled_replica_scores_a_ticket_its_hedge_answered_in_the_reference_only(m):
    """Replica 0 stalls 0.5 s on its batch; the ticket is hedged to replica
    1 after 0.05 s and answered there during the stall.  The reference's
    replica 0 then searches the answered ticket anyway (its scorer is
    called once a round); the port's drops it first and scores nothing."""
    def run(pkg):
        plan = pkg.FaultPlan(sleep_faults=[pkg.SleepFault(replica=0, seconds=0.5,
                                                          request_seq=0)])
        router = _fleet(pkg, m, 2, plan=plan, record_pairs=True, queue_limit=8,
                        hedge_after_s=0.05)
        try:
            out = router.result(router.submit(10), timeout=60)
            t_end = time.monotonic() + 30.0
            while router.replicas[0].step < 1 and time.monotonic() < t_end:
                time.sleep(0.01)
            assert router.replicas[0].step == 1       # the stalled batch has ended
            scored = len(router.replicas[0].service._scorer.call_log)
        finally:
            router.close()
        assert out.status == "ok" and out.replica == 1 and out.hedged
        assert out.latency_s < 0.5                    # answered inside the stall
        return scored

    assert run(jfaults) == CFG.n_rounds + 1
    assert run(tfaults) == 0


def test_launch_counter_counts_every_thread():
    """4 threads x 2,000 adds through a kernel wrapper's counter give
    exactly 8,000 (switching threads every microsecond, where a bare
    read-add-write loses counts)."""
    from repro_torch.kernels.approx_topk import kernel

    counter = kernel.launches
    kernels.reset_launches()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [counter.add() for _ in range(2000)])
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert kernels.launch_counts()["approx_topk"] == 8000
    kernels.reset_launches()
    assert kernels.launch_counts()["approx_topk"] == 0
