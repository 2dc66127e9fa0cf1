"""The paper's budget-matched comparison in the port, held against the JAX
package run live on the same numpy inputs: ANNCUR and retrieve-and-rerank
retrievers, the ``eligible`` operand, anytime deadlines, the DE first stage
and the DE-hybrid, the IR metrics and ``quality_matrix``, and the serve
CLI's new flags.

Both packages search one tabulated score matrix (the JAX package's
synthetic domain, carried across as numpy).  Tolerances:

- ids: equal where both packages' arithmetic is exact (retriever-seeded
  rounds, exact-score rankings, the dual-encoder order); ADACUR-based
  searches at the engine's own bar, top-k overlap >= 0.99 (ROADMAP.md,
  queue 3: the reference disagrees with itself beyond that);
- latents: U and E_I within atol 1e-4 (the pinv's SVD rounds differently
  in LAPACK and XLA; entries are O(0.1)-O(1));
- CE accounting: measured == planned, exactly;
- ``quality_matrix`` recall within 0.02 of the reference's;
- IR metrics on the same rankings: equal to 1e-12 (both in float64).
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AdaCURConfig as JConfig  # noqa: E402
from repro.core import candidates as jcand  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.index import AnchorIndex as JIndex  # noqa: E402
from repro.core.retrieval import rerank_baseline as j_rerank_baseline  # noqa: E402
from repro.core.scorer import TabulatedScorer as JTab  # noqa: E402
from repro.data.synthetic import make_synthetic_ce  # noqa: E402
from repro.eval import harness as jharness  # noqa: E402
from repro.eval import metrics as jmetrics  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import AdaCURConfig  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.candidates import (  # noqa: E402
    DualEncoderCandidates, HybridRetriever, candidate_eligibility,
)
from repro_torch.core.index import AnchorIndex  # noqa: E402
from repro_torch.core.retrieval import rerank_baseline  # noqa: E402
from repro_torch.core.scorer import TabulatedScorer  # noqa: E402
from repro_torch.eval import harness, metrics  # noqa: E402
from repro_torch.kernels.approx_topk.ops import approx_topk_op  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.testing import topk_overlap  # noqa: E402

N_ITEMS, K_Q, B = 1500, 80, 12
LATENT_ATOL = 1e-4
CFG = dict(k_anchor=20, n_rounds=4, budget_ce=40, k_retrieve=20, loop_mode="fori",
           use_fused_topk=True, fused_tile=256)


@pytest.fixture(scope="module")
def dom():
    ce = make_synthetic_ce(jax.random.PRNGKey(0), n_queries=K_Q + B, n_items=N_ITEMS)
    m = np.asarray(ce.full_matrix(jnp.arange(K_Q + B)))
    fields = {k: np.asarray(getattr(ce, k)) for k in convert.SYNTHETIC_CE_FIELDS}
    fields.update(gamma=ce.gamma, sigma=ce.sigma)
    return dict(ce=ce, tce=convert.synthetic_ce(fields, device="cpu"), m=m,
                q=np.arange(K_Q, K_Q + B))


def _indexes(dom, payload="float32"):
    j = JIndex.from_r_anc(jnp.asarray(dom["m"][:K_Q]))
    t = AnchorIndex.from_r_anc(torch.from_numpy(dom["m"][:K_Q].copy()))
    if payload != "float32":
        j, t = j.quantize(payload), t.quantize(payload)
    return j, t


def _key(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


def test_with_anchors_and_latents_match(dom):
    """``with_anchors(key)`` draws the reference's anchors; ``with_latents``'
    U and E_I agree within LATENT_ATOL; ``query_embedding`` follows."""
    j, t = _indexes(dom)
    jk, tk = _key(5)
    ja, ta = j.with_latents(k_anchor=30, key=jk), t.with_latents(k_anchor=30, key=tk)
    assert np.array_equal(np.asarray(ja.anchor_item_pos), ta.anchor_item_pos.numpy())
    assert ta.has_latents and not t.has_latents
    np.testing.assert_allclose(ta.u.numpy(), np.asarray(ja.u), atol=LATENT_ATOL, rtol=0)
    np.testing.assert_allclose(ta.item_embeddings.numpy(), np.asarray(ja.item_embeddings),
                               atol=LATENT_ATOL, rtol=0)
    c = dom["m"][K_Q:, np.asarray(ja.anchor_item_pos)]
    np.testing.assert_allclose(ta.query_embedding(torch.from_numpy(c)).numpy(),
                               np.asarray(ja.query_embedding(jnp.asarray(c))),
                               atol=LATENT_ATOL, rtol=0)


@pytest.mark.parametrize("payload", ["float32", "int8"])
def test_anchor_index_topk_matches(dom, payload):
    """``AnchorIndex.topk`` over a padded index (valid items only) returns
    the reference's ids; the valid mask marks the same positions."""
    rng = np.random.default_rng(1)
    e = rng.standard_normal((B, K_Q)).astype(np.float32)
    j = JIndex.from_r_anc(jnp.asarray(dom["m"][:K_Q]), capacity=N_ITEMS + 100)
    t = AnchorIndex.from_r_anc(torch.from_numpy(dom["m"][:K_Q].copy()), capacity=N_ITEMS + 100)
    if payload != "float32":
        j, t = j.quantize(payload), t.quantize(payload)
    assert np.array_equal(np.asarray(j.valid_mask()), t.valid_mask().numpy())
    _, ji = j.topk(jnp.asarray(e), 50)
    tv, ti = t.topk(torch.from_numpy(e), 50)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert (ti < N_ITEMS).all()


@pytest.mark.parametrize("payload", ["float32", "int8"])
def test_anncur_matches(dom, payload):
    """ANNCUR over the same anchors (the reference's draw) returns the
    reference's ids, ranked by the same exact scores, at the planned CE."""
    j, t = _indexes(dom, payload)
    jk, tk = _key(11)
    jr = jeng.ANNCURRetriever.from_index(j.with_anchors(k_anchor=20, key=jk), JTab(dom["m"]),
                                         budget_ce=40, k_retrieve=20)
    scorer = TabulatedScorer(dom["m"])
    tr = teng.ANNCURRetriever.from_index(t.with_anchors(k_anchor=20, key=tk), scorer,
                                         budget_ce=40, k_retrieve=20,
                                         base_cfg=AdaCURConfig(use_fused_topk=True,
                                                               fused_tile=256))
    jres = jr.search(jnp.asarray(dom["q"]), jax.random.PRNGKey(0))
    tres = tr.search(torch.as_tensor(dom["q"]), prng.PRNGKey(0))
    assert topk_overlap(np.asarray(jres.topk_idx), tres.topk_idx) >= 0.99
    assert np.array_equal(np.asarray(jres.anchor_idx), tres.anchor_idx.numpy())
    assert scorer.stats.ce_calls == 40 * B == tres.ce_calls * B
    assert isinstance(tr, teng.Retriever)


def test_anncur_without_rerank_budget_ranks_its_anchors_by_exact_score(dom):
    _, t = _indexes(dom)
    t = t.with_anchors(k_anchor=20, key=prng.PRNGKey(3))
    tr = teng.ANNCURRetriever.from_index(t, TabulatedScorer(dom["m"]), budget_ce=20,
                                         k_retrieve=10)
    res = tr.search(torch.as_tensor(dom["q"]))
    anchors = t.anchor_item_pos.numpy()
    for row, q in enumerate(dom["q"]):
        exact = dom["m"][q, anchors]
        want = anchors[np.argsort(-exact, kind="stable")[:10]]
        assert np.array_equal(res.topk_idx[row].numpy(), want)
        np.testing.assert_array_equal(res.topk_scores[row].numpy(), np.sort(exact)[::-1][:10])


@pytest.mark.parametrize("payload", ["float32", "int8"])
def test_rerank_matches(dom, payload):
    """Retrieve-and-rerank (the engine configuration) and the plain
    ``rerank_baseline`` return the reference's ids and scores."""
    j, t = _indexes(dom, payload)
    rng = np.random.default_rng(2)
    cand = np.stack([rng.permutation(N_ITEMS)[:60] for _ in range(B)]).astype(np.int32)
    jr = jeng.RerankRetriever.from_index(j, JTab(dom["m"]), budget_ce=40, k_retrieve=20)
    tr = teng.RerankRetriever.from_index(t, TabulatedScorer(dom["m"]), budget_ce=40,
                                         k_retrieve=20)
    jres = jr.search(jnp.asarray(dom["q"]), candidate_idx=jnp.asarray(cand))
    tres = tr.search(torch.as_tensor(dom["q"]), candidate_idx=torch.from_numpy(cand))
    assert np.array_equal(np.asarray(jres.topk_idx), tres.topk_idx.numpy())
    np.testing.assert_array_equal(np.asarray(jres.topk_scores), tres.topk_scores.numpy())
    jb = j_rerank_baseline(JTab(dom["m"]), jnp.asarray(cand), jnp.asarray(dom["q"]), 40, 20)
    tb = rerank_baseline(TabulatedScorer(dom["m"]), torch.from_numpy(cand),
                         torch.as_tensor(dom["q"]), 40, 20)
    assert np.array_equal(np.asarray(jb.topk_idx), tb.topk_idx.numpy())
    assert np.array_equal(tb.topk_idx.numpy(), tres.topk_idx.numpy())


@pytest.mark.parametrize("mode", ["staged", "persistent-early"])
def test_eligible_search_matches_and_never_leaves_the_candidates(dom, mode):
    """A per-query ``eligible`` search returns the reference's ids (overlap
    >= 0.99), never samples or reranks an ineligible item, and spends
    exactly the plan."""
    rng = np.random.default_rng(4)
    elig = np.zeros((B, N_ITEMS), bool)
    for row in range(B):
        elig[row, rng.permutation(N_ITEMS)[:200]] = True
    kw = dict(CFG, incremental_pinv=False)
    if mode == "persistent-early":
        kw.update(round_kernel="persistent", early_exit_tol=0.5)
    jres = jeng.engine_search(JTab(dom["m"]), jnp.asarray(dom["m"][:K_Q]), jnp.asarray(dom["q"]),
                              JConfig(**kw), jax.random.PRNGKey(3), eligible=jnp.asarray(elig))
    scorer = TabulatedScorer(dom["m"], record_pairs=True)
    tres = teng.engine_search(scorer, torch.from_numpy(dom["m"][:K_Q].copy()),
                              torch.as_tensor(dom["q"]), AdaCURConfig(**kw), prng.PRNGKey(3),
                              eligible=torch.from_numpy(elig))
    assert int(jres.rounds_done) == tres.rounds_done
    assert topk_overlap(np.asarray(jres.topk_idx), tres.topk_idx) >= 0.99
    for _, idx in scorer.call_log:
        assert np.take_along_axis(elig, idx.astype(np.int64), 1).all()
    assert scorer.stats.ce_calls == teng.ce_call_plan(AdaCURConfig(**kw), tres.rounds_done) * B


class _FakeClock:
    """``time.monotonic`` that advances one second per read."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 1.0
        return self.t


@pytest.mark.parametrize("early_exit", [False, True])
def test_deadline_cut_equals_the_explicit_round_count(dom, monkeypatch, early_exit):
    """With the clock faked, a deadline that expires after two polls cuts
    the search at round 3 of 4: the result equals an explicit
    ``n_rounds=3`` search, ``fired`` is set, and the CE spend is
    ``ce_call_plan(cfg, 3)`` a row.  A deadline in the past leaves one round
    and the rerank; a far one runs every round and does not fire."""
    _, t = _indexes(dom)
    kw = dict(CFG, early_exit_tol=1e-9) if early_exit else CFG
    cfg = AdaCURConfig(**kw)
    scorer = TabulatedScorer(dom["m"])
    ret = teng.AdaCURRetriever.from_index(t, scorer, cfg, anytime=True)
    q = torch.as_tensor(dom["q"])
    clock = _FakeClock()
    monkeypatch.setattr(teng.time, "monotonic", clock)
    cut = ret.search(q, prng.PRNGKey(1), deadline_t=clock.t + 2.5)
    assert ret.deadline.fired and cut.rounds_done == 3
    assert scorer.stats.ce_calls == teng.ce_call_plan(cfg, 3) * B
    ref = ret.search(q, prng.PRNGKey(1), n_rounds=3)
    assert torch.equal(cut.topk_idx, ref.topk_idx)
    assert torch.equal(cut.topk_scores, ref.topk_scores)
    scorer.reset_stats()
    one = ret.search(q, prng.PRNGKey(1), deadline_t=clock.t - 10.0)
    assert one.rounds_done == 1 and ret.deadline.fired
    assert scorer.stats.ce_calls == teng.ce_call_plan(cfg, 1) * B
    full = ret.search(q, prng.PRNGKey(1), deadline_t=clock.t + 1e9)
    assert full.rounds_done == cfg.n_rounds and not ret.deadline.fired
    with pytest.raises(ValueError, match="anytime"):
        teng.AdaCURRetriever.from_index(t, scorer, cfg).search(q, deadline_t=0.0)


def test_service_serves_a_deadline(dom):
    """Through ``AdaCURService``: an expired request deadline gives
    degraded one-round answers at ``ce_call_plan(cfg, 1)`` a request; no
    deadline gives full, undegraded ones."""
    _, t = _indexes(dom)
    cfg = AdaCURConfig(**CFG)
    svc = serve.AdaCURService(retriever=teng.AdaCURRetriever.from_index(
        t, TabulatedScorer(dom["m"]), cfg, anytime=True), max_batch=4, max_wait_s=60.0)
    past = time.monotonic() - 1.0
    out = []
    for q in dom["q"][:4]:
        out += svc.submit(serve.RetrievalRequest(query_id=int(q), deadline_t=past)) or []
    assert len(out) == 4
    assert all(r.status == "ok" and r.degraded and r.rounds_completed == 1 for r in out)
    assert all(r.measured_ce_calls == teng.ce_call_plan(cfg, 1) for r in out)
    out = []
    for q in dom["q"][:4]:
        out += svc.submit(serve.RetrievalRequest(query_id=int(q))) or []
    assert all(not r.degraded and r.rounds_completed == cfg.n_rounds for r in out)
    assert all(r.measured_ce_calls == teng.ce_call_plan(cfg) for r in out)


@pytest.mark.parametrize("payload", ["float32", "bfloat16", "int8", "fp8", "int4"])
def test_engine_slab_bytes_match(payload):
    cfg_kw = dict(k_anchor=100, n_rounds=5, budget_ce=200, payload_dtype=payload)
    for kw in (dict(), dict(n_data_shards=2, n_item_shards=4)):
        want = jeng.engine_slab_bytes(JConfig(**cfg_kw), 256, 1_000_000, 500, payload=payload,
                                      **kw)
        got = teng.engine_slab_bytes(AdaCURConfig(**cfg_kw), 256, 1_000_000, 500,
                                     payload=payload, **kw)
        assert got == want


def test_round_body_bn_intermediates_match(dom):
    """The dense round materializes (B, N) floats (>= 1 in both packages);
    the fused TopK round none (0 in both)."""
    jce = dom["ce"].score_fn()
    r_anc = dom["m"][:K_Q]
    dense = dict(k_anchor=20, n_rounds=4, budget_ce=40, k_retrieve=20)
    fused = dict(dense, use_fused_topk=True, fused_tile=256)
    for kw, zero in ((dense, False), (fused, True)):
        jn = jeng.round_body_bn_intermediates(jce, jnp.asarray(r_anc), jnp.asarray(dom["q"]),
                                              JConfig(**kw))
        tn = teng.round_body_bn_intermediates(TabulatedScorer(dom["m"]),
                                              torch.from_numpy(r_anc.copy()),
                                              torch.as_tensor(dom["q"]), AdaCURConfig(**kw))
        assert (jn == 0) == zero and (tn == 0) == zero, (kw, jn, tn)


def test_ir_metrics_and_qrels_match(dom):
    rng = np.random.default_rng(6)
    exact = dom["m"][K_Q:]
    ranked = np.stack([rng.permutation(N_ITEMS)[:30] for _ in range(B)]).astype(np.int32)
    ranked[:, 0] = np.argmax(exact, axis=1)[: B]
    ranked[0, :3] = ranked[0, 0]                  # a padded row repeats its best id
    for k in (1, 5):
        jq = jmetrics.qrels_from_exact(jnp.asarray(exact), k=k)
        tq = metrics.qrels_from_exact(torch.from_numpy(exact.copy()), k=k)
        assert jq == tq
        want = jmetrics.ir_metrics(ranked, jq, ks=(1, 10, 30))
        got = metrics.ir_metrics(torch.from_numpy(ranked), tq, ks=(1, 10, 30))
        assert want.keys() == got.keys()
        for name in want:
            assert abs(want[name] - got[name]) <= 1e-12, name
    gold = rng.integers(0, N_ITEMS, B)
    graded = [{int(i): float(g) for i, g in zip(row[:3], (3.0, 1.0, 0.5))} for row in ranked]
    for jq, tq in ((jmetrics.qrels_from_gold(gold), metrics.qrels_from_gold(gold)),
                   (graded, graded)):
        assert jq == tq
        want = jmetrics.ir_metrics(ranked, jq)
        got = metrics.ir_metrics(ranked, tq)
        assert all(abs(want[n] - got[n]) <= 1e-12 for n in want)

    class _Res:
        topk_idx, ce_calls = None, 40

    jr, tr = _Res(), _Res()
    jr.topk_idx, tr.topk_idx = jnp.asarray(ranked), torch.from_numpy(ranked)
    want = jmetrics.evaluate_result("x", jr, jnp.asarray(exact), ks=(1, 10, 30))
    got = metrics.evaluate_result("x", tr, torch.from_numpy(exact.copy()), ks=(1, 10, 30))
    assert got.budget_ce == want.budget_ce
    for k in (1, 10, 30):
        assert abs(got.recall[k] - want.recall[k]) <= 1e-6


@pytest.mark.parametrize("k", [200, 800])
def test_dual_encoder_candidates_match(dom, k):
    """The DE shortlist (through the fused op over the (d, N) transposed
    embeddings; k = 800 is the hybrid's 4 x budget) and its eligibility
    mask equal the reference's."""
    ce, tce = dom["ce"], dom["tce"]
    # one item tile: the reference's scan backend takes k up to its tile
    jde = jcand.DualEncoderCandidates(ce.q_emb, ce.i_emb, n_valid=N_ITEMS - 7, tile=2048)
    tde = DualEncoderCandidates(tce.q_emb, tce.i_emb, n_valid=N_ITEMS - 7, tile=2048)
    ji = np.asarray(jde(jnp.asarray(dom["q"]), k))
    ti = tde(torch.as_tensor(dom["q"]), k)
    assert np.array_equal(ji, ti.numpy()) and (ti < N_ITEMS - 7).all()
    assert tde.stats.requests == 1 and tde.stats.candidates == B * k
    for per_query in (True, False):
        want = np.asarray(jcand.candidate_eligibility(jnp.asarray(ji), N_ITEMS, per_query))
        assert np.array_equal(candidate_eligibility(ti, N_ITEMS, per_query).numpy(), want)


def test_hybrid_mask_mode_matches_and_subset_is_refused(dom):
    """Mask mode against the reference's.  Subset mode, once refused, is
    served now (``tests/test_torch_candidates.py`` holds it to the
    reference): here it keeps every result inside the batch's union."""
    ce, tce = dom["ce"], dom["tce"]
    j, t = _indexes(dom)
    jh = jcand.HybridRetriever(score_fn=JTab(dom["m"]), generator=jcand.DualEncoderCandidates(
        ce.q_emb, ce.i_emb), cfg=JConfig(**CFG), index=j, shortlist_k=160, mode="mask")
    scorer = TabulatedScorer(dom["m"])
    th = HybridRetriever(score_fn=scorer, generator=DualEncoderCandidates(tce.q_emb, tce.i_emb),
                         cfg=AdaCURConfig(**CFG), index=t, shortlist_k=160, mode="mask")
    jres = jh.search(jnp.asarray(dom["q"]), jax.random.PRNGKey(2))
    tres = th.search(torch.as_tensor(dom["q"]), prng.PRNGKey(2))
    assert topk_overlap(np.asarray(jres.topk_idx), tres.topk_idx) >= 0.99
    assert scorer.stats.ce_calls == th.ce_call_plan() * B
    sub = HybridRetriever(score_fn=scorer, generator=th.generator, cfg=AdaCURConfig(**CFG),
                          index=t, shortlist_k=160, mode="subset")
    union = set(th.generator(torch.as_tensor(dom["q"]), 160).flatten().tolist())
    res = sub.search(torch.as_tensor(dom["q"]), prng.PRNGKey(2))
    assert set(res.topk_idx.flatten().tolist()) <= union


def test_quality_matrix_matches(dom):
    """The four rows of the budget-matched matrix: the same plan, measured
    CE and ``budget_matched`` as the reference's, recall within 0.02."""
    ce, tce = dom["ce"], dom["tce"]
    jidx, tidx = _indexes(dom)
    kw = dict(budget=40, n_rounds=4, ks=(1, 10, 20), shortlist_k=160, seed=0)
    want = jharness.quality_matrix(ce, jidx, dom["q"], dom["m"], **kw)
    got = harness.quality_matrix(tce, tidx, dom["q"], torch.from_numpy(dom["m"].copy()),
                                 use_fused_topk=True, **kw)
    assert [r.method for r in got] == [r.method for r in want] == [
        "adacur", "anncur", "rerank_de", "hybrid_de"]
    for w, g in zip(want, got):
        assert (g.planned_ce, g.measured_ce, g.budget_matched) == (
            w.planned_ce, w.measured_ce, w.budget_matched), g.method
        assert g.budget_matched
        for k in (1, 10, 20):
            assert abs(g.topk_recall[k] - w.topk_recall[k]) <= 0.02, (g.method, k)
        assert set(g.ir) == set(w.ir) and g.to_json()["method"] == g.method


@pytest.mark.parametrize("k", [257, 800])
def test_plain_approx_topk_takes_large_k(k):
    """The plain version (the CPU path and the card's yardstick) at k above
    the old 256 limit, against the reference's scan backend, with noise,
    a mask, anchors and ``n_valid`` (tiles of 1,000 items: the reference's
    scan backend takes k up to its tile width)."""
    from repro.kernels.approx_topk.ops import approx_topk_op as j_op

    rng = np.random.default_rng(k)
    b, k_q, n = 6, 48, 3000
    e = rng.standard_normal((b, k_q)).astype(np.float32)
    r = rng.standard_normal((k_q, n)).astype(np.float32)
    noise = rng.random((b, n)).astype(np.float32)
    mask = rng.random((b, n)) < 0.2
    anc = rng.integers(0, n, (b, 30)).astype(np.int32)
    jv, ji = j_op(jnp.asarray(e), jnp.asarray(r), jnp.asarray(anc), k, tile=1024, impl="scan",
                  noise=jnp.asarray(noise), mask=jnp.asarray(mask), n_valid=n - 9)
    tv, ti = approx_topk_op(torch.from_numpy(e), torch.from_numpy(r), torch.from_numpy(anc), k,
                            tile=1024, noise=torch.from_numpy(noise), mask=torch.from_numpy(mask),
                            n_valid=n - 9)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("flags", [["--retriever", "anncur"], ["--retriever", "rerank"],
                                   ["--first-stage", "de"]])
def test_serve_cli_serves_the_other_methods_on_the_cpu(flags, capsys):
    serve.main(["--device", "cpu", "--fused", "--n-items", "1000", "--requests", "6",
                "--batch", "4", *flags])
    assert "served 6 requests (0 errors)" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--scorer", "real-ce", "--retriever", "rerank"],
                                   ["--mesh", "2x4"],
                                   ["--retriever", "rerank", "--first-stage", "de"]])
def test_serve_cli_refuses_what_is_not_ported(flags):
    # --mesh is ported: without torchrun's ranks it is refused, naming torchrun
    with pytest.raises(SystemExit, match="ROADMAP|--retriever adacur|torchrun"):
        serve.main(["--device", "cpu", *flags])
