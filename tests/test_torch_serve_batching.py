"""The port's AdaCURService micro-batching edges (``tests/test_serve_batching.py``,
ported): empty flush, deadline stragglers padded into static batch
buckets, a padded flush replayed bit for bit, swap_index racing queued
requests, and measured cache-hit accounting across requests sharing
(query, item) pairs.  Then the service's ``deterministic=`` and bare
``r_anc=`` paths held live against the reference's service on the same
matrix: the same ids request for request (top-k overlap >= 0.99, scores
within 1e-5, the bar of ``tests/test_engine.py``)."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AdaCURConfig as JConfig  # noqa: E402
from repro.core.scorer import TabulatedScorer as JTabulated  # noqa: E402
from repro.launch.serve import AdaCURService as JService  # noqa: E402
from repro.launch.serve import RetrievalRequest as JRequest  # noqa: E402
from repro_torch.configs.base import AdaCURConfig  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.engine import AdaCURRetriever  # noqa: E402
from repro_torch.core.index import AnchorIndex  # noqa: E402
from repro_torch.core.scorer import CachingScorer, TabulatedScorer  # noqa: E402
from repro_torch.data.synthetic import make_synthetic_ce  # noqa: E402
from repro_torch.launch.serve import AdaCURService, RetrievalRequest  # noqa: E402
from repro_torch.testing import topk_overlap  # noqa: E402

N_Q, N_ITEMS = 60, 100
CFG_KW = dict(k_anchor=8, n_rounds=2, budget_ce=16, k_retrieve=5, loop_mode="fori")
CFG = AdaCURConfig(**CFG_KW)


@pytest.fixture(scope="module")
def m():
    ce = make_synthetic_ce(prng.PRNGKey(0), n_queries=N_Q, n_items=N_ITEMS, device="cpu")
    return ce.full_matrix(torch.arange(N_Q)).numpy()


def _r_anc(m):
    return torch.from_numpy(m[:40].copy())


def _service(m, *, item_offset=0, deterministic=False, max_batch=4,
             batch_buckets=None, max_wait_s=60.0, cache=True):
    """Index-backed service; ``item_offset`` shifts the external item ids
    (the scorer's matrix is widened to keep external ids addressable)."""
    wide = np.zeros((N_Q, item_offset + N_ITEMS), dtype=np.float32)
    wide[:, item_offset:] = m
    scorer = TabulatedScorer(wide)
    score_fn = CachingScorer(scorer) if cache else scorer
    index = AnchorIndex.from_r_anc(
        _r_anc(m), item_ids=torch.arange(item_offset, item_offset + N_ITEMS, dtype=torch.int32))
    retriever = AdaCURRetriever.from_index(index, score_fn, CFG)
    return AdaCURService(retriever=retriever, max_batch=max_batch, max_wait_s=max_wait_s,
                         batch_buckets=batch_buckets, deterministic=deterministic)


class TestFlushEdges:
    def test_empty_flush_and_poll(self, m):
        svc = _service(m)
        assert svc.flush() == []
        assert svc.poll() == []

    def test_deadline_straggler_partial_bucket(self, m):
        """A lone queued request is flushed by the event loop's poll after
        the deadline, padded up to a static bucket; the padding never
        reaches the response."""
        svc = _service(m, max_wait_s=0.01, batch_buckets=[2, 4])
        assert svc.submit(RetrievalRequest(query_id=45)) is None
        assert svc.poll() == []                 # not overdue yet
        time.sleep(0.02)
        out = svc.poll()
        assert [r.query_id for r in out] == [45]
        assert len(out[0].item_ids) == CFG.k_retrieve
        assert (out[0].item_ids < N_ITEMS).all()
        assert svc.flush() == []                # queue fully drained

    def test_padded_flush_is_valid_and_reproducible(self, m):
        """A padded partial bucket serves exactly its real requests with
        exact CE scores, and (deterministic mode) the same batch composition
        replays bit-identically."""
        svc = _service(m, deterministic=True, max_batch=4, batch_buckets=[4], cache=False)
        svc.submit(RetrievalRequest(query_id=41))
        svc.submit(RetrievalRequest(query_id=53))
        a = svc.flush()                        # 2 real rows padded to 4
        assert [r.query_id for r in a] == [41, 53]
        for r in a:
            assert (0 <= r.item_ids).all() and (r.item_ids < N_ITEMS).all()
            # returned scores are the exact CE scores of the returned ids
            np.testing.assert_allclose(r.scores, m[r.query_id][r.item_ids], atol=1e-5, rtol=1e-5)
        svc.submit(RetrievalRequest(query_id=41))
        svc.submit(RetrievalRequest(query_id=53))
        b = svc.flush()
        for ra, rb in zip(a, b):
            np.testing.assert_array_equal(ra.item_ids, rb.item_ids)
            np.testing.assert_array_equal(ra.scores, rb.scores)


class TestSwapIndexRacing:
    def test_queued_requests_drain_against_admitting_index(self, m):
        """Requests queued before swap_index are served by the index they
        were admitted under; the swap only affects later requests.  The two
        indices expose disjoint external id ranges, so mixing would show."""
        svc = _service(m, item_offset=1000, deterministic=True)
        new_index = AnchorIndex.from_r_anc(
            _r_anc(m), item_ids=torch.arange(2000, 2000 + N_ITEMS, dtype=torch.int32))
        wide = np.zeros((N_Q, 2000 + N_ITEMS), dtype=np.float32)
        wide[:, 1000:1000 + N_ITEMS] = m
        wide[:, 2000:] = m
        svc._scorer.inner.matrix = torch.from_numpy(wide)

        svc.submit(RetrievalRequest(query_id=44))
        svc.submit(RetrievalRequest(query_id=47))
        drained = svc.swap_index(new_index)
        assert [r.query_id for r in drained] == [44, 47]
        for r in drained:
            assert (r.item_ids >= 1000).all() and (r.item_ids < 2000).all()
        assert svc.index is new_index and svc.retriever.index is new_index

        # same batch composition after the swap: deterministic mode and the
        # same bucket replay the same trajectories, so only the id
        # namespace may differ
        svc.submit(RetrievalRequest(query_id=44))
        svc.submit(RetrievalRequest(query_id=47))
        after = svc.flush()
        for r_new, r_old in zip(after, drained):
            assert (r_new.item_ids >= 2000).all()
            np.testing.assert_array_equal(r_new.item_ids - 1000, r_old.item_ids)
            np.testing.assert_array_equal(r_new.scores, r_old.scores)

    def test_swap_requires_index_backed_retriever(self, m):
        scorer = TabulatedScorer(m)
        retr = AdaCURRetriever(scorer, _r_anc(m), CFG)
        svc = AdaCURService(retriever=retr, max_batch=2)
        with pytest.raises(ValueError, match="index-backed"):
            svc.swap_index(AnchorIndex.from_r_anc(_r_anc(m)))


class TestMeasuredAccounting:
    def test_cache_hits_across_requests_sharing_pairs(self, m):
        """Two identical requests: the second is served entirely from the
        score cache (deterministic mode pins the trajectory), and the
        response-level measured accounting shows it."""
        svc = _service(m, deterministic=True, batch_buckets=[1, 2, 4])
        assert svc.submit(RetrievalRequest(query_id=50)) is None
        (r1,) = svc.flush()
        assert r1.measured_ce_calls == CFG.budget_ce
        assert r1.cache_hits == 0
        assert svc.submit(RetrievalRequest(query_id=50)) is None
        (r2,) = svc.flush()
        assert r2.measured_ce_calls == 0
        assert r2.cache_hits == CFG.budget_ce
        np.testing.assert_array_equal(r1.item_ids, r2.item_ids)
        np.testing.assert_array_equal(r1.scores, r2.scores)
        # planned budget is still reported alongside the measured cost
        assert r1.ce_calls == CFG.budget_ce

    def test_partial_sharing_between_queries(self, m):
        """The cache is pair-keyed: a different query touching the same
        items shares no (q, i) pairs, so measured calls stay at the full
        budget."""
        svc = _service(m, deterministic=True, batch_buckets=[1, 2, 4])
        svc.submit(RetrievalRequest(query_id=50))
        (r1,) = svc.flush()
        svc.submit(RetrievalRequest(query_id=51))
        (r2,) = svc.flush()
        assert r2.measured_ce_calls == CFG.budget_ce
        assert r2.cache_hits == 0

    def test_bare_score_fn_reports_no_measured_stats(self, m):
        svc = _service(m, cache=False)
        svc.submit(RetrievalRequest(query_id=42))
        (r,) = svc.flush()
        # TabulatedScorer is a Scorer: measured stats present even uncached
        assert r.measured_ce_calls == CFG.budget_ce
        assert svc.scorer_stats is not None

        def bare(q, idx):
            return torch.zeros(idx.shape, dtype=torch.float32)

        retr = AdaCURRetriever.from_index(AnchorIndex.from_r_anc(_r_anc(m)), bare, CFG)
        svc2 = AdaCURService(retriever=retr, max_batch=2)
        svc2.submit(RetrievalRequest(query_id=42))
        (r2,) = svc2.flush()
        assert r2.measured_ce_calls is None and svc2.scorer_stats is None


@pytest.mark.parametrize("buckets", [[1], [2, 4]])
def test_deterministic_service_matches_reference(m, buckets):
    """``deterministic=True`` with the same seed: the port's service, built
    from a bare ``r_anc``, returns the reference service's ids request for
    request, flush after flush (each flush reuses the seed key)."""
    qids = [int(q) for q in np.random.default_rng(1).integers(40, N_Q, 12)]
    max_batch = buckets[-1]
    j_svc = JService(score_fn=JTabulated(m), r_anc=jnp.asarray(m[:40]), cfg=JConfig(**CFG_KW),
                     max_batch=max_batch, max_wait_s=60.0, seed=7, batch_buckets=buckets,
                     deterministic=True)
    t_svc = AdaCURService(score_fn=TabulatedScorer(m), r_anc=m[:40], cfg=CFG,
                          max_batch=max_batch, max_wait_s=60.0, seed=7,
                          batch_buckets=buckets, deterministic=True, device="cpu")
    assert t_svc.index.device == torch.device("cpu") and t_svc.index.n_items == N_ITEMS
    outs = []
    for svc, req in ((j_svc, JRequest), (t_svc, RetrievalRequest)):
        served = []
        for i, q in enumerate(qids):
            served += svc.submit(req(query_id=q)) or []
            if i % 3 == 2:                   # partial buckets too
                served += svc.flush()
        served += svc.flush()
        outs.append(served)
    assert [r.query_id for r in outs[1]] == [r.query_id for r in outs[0]] == qids
    j_ids = np.stack([r.item_ids for r in outs[0]])
    t_ids = np.stack([r.item_ids for r in outs[1]])
    assert topk_overlap(t_ids, j_ids) >= 0.99
    same = t_ids == j_ids
    np.testing.assert_allclose(np.stack([r.scores for r in outs[1]])[same],
                               np.stack([r.scores for r in outs[0]])[same], atol=1e-5, rtol=0)
    # the seed key is reused, never split
    assert torch.equal(t_svc._key, prng.PRNGKey(7))
