"""The rest of the port's hybrid retrieval held against the JAX package run
live: ``lexical_signatures``, ``BM25Candidates``, ``OracleCandidates``,
``union_candidates``, ``quant.subset_columns``, ``sampling.gumbel_at`` and
the §3.2 oracles, the engine's ``pos_map`` (subset search), the subset-mode
``HybridRetriever`` and the harness's ``hybrid_bm25`` row.

Tolerances:

- token signatures, union, oracle candidates, subset payload bytes:
  equal;
- BM25 order: the tie-aware comparator of ``repro_torch.testing`` (numpy's
  and torch's fp32 products sum in other orders, and BM25 scores tie often);
- ``gumbel_at``: bit-equal to the port's ``blocked_gumbel`` at the same
  coordinates; against the reference, threefry's integer bits equal and
  the floats within ``tests/test_torch_prng.py``'s atol 1e-6;
- the port's subset search: bitwise equal to its own search masked to the
  union (the reference's contract, over its ``SUBSET_CONFIGS``); against
  the reference's subset search, top-k overlap >= 0.99 (ROADMAP.md: the
  engine-level bar);
- ``hybrid_bm25``: plan, measured CE and ``budget_matched`` equal to the
  reference's; recall within 0.02.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AdaCURConfig as JConfig  # noqa: E402
from repro.core import candidates as jcand  # noqa: E402
from repro.core import sampling as jsampling  # noqa: E402
from repro.core.index import AnchorIndex as JIndex  # noqa: E402
from repro.core.scorer import TabulatedScorer as JTab  # noqa: E402
from repro.data.synthetic import lexical_signatures as j_lexical_signatures  # noqa: E402
from repro.data.synthetic import make_synthetic_ce  # noqa: E402
from repro.eval import harness as jharness  # noqa: E402
from repro.kernels.approx_topk import quant as jquant  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import AdaCURConfig  # noqa: E402
from repro_torch.core import prng, sampling  # noqa: E402
from repro_torch.core.candidates import (  # noqa: E402
    BM25Candidates, CandidateGenerator, DualEncoderCandidates, HybridRetriever,
    OracleCandidates, candidate_eligibility, union_candidates,
)
from repro_torch.core.engine import engine_search  # noqa: E402
from repro_torch.core.index import AnchorIndex  # noqa: E402
from repro_torch.core.scorer import TabulatedScorer  # noqa: E402
from repro_torch.data.synthetic import lexical_signatures  # noqa: E402
from repro_torch.eval import harness  # noqa: E402
from repro_torch.kernels.approx_topk import quant  # noqa: E402
from repro_torch.testing import topk_overlap, topk_report  # noqa: E402

# the reference's subset-parity domain (tests/test_candidates.py)
N_ANCHOR_Q, N_TEST_Q, N_ITEMS = 48, 6, 384
GUMBEL_ATOL = 1e-6
PAYLOADS = ["float32", "bfloat16", "int8", "int4", "fp8"]
SUBSET_CONFIGS = [
    ("unrolled", "topk", "float32", False),
    ("fori", "topk", "int8", False),
    ("fori", "softmax", "float32", True),
    ("early", "random", "int8", True),
    ("early", "topk", "float32", True),
    ("fori", "random", "float32", False),
]


@pytest.fixture(scope="module")
def dom():
    ce = make_synthetic_ce(jax.random.PRNGKey(0), n_queries=N_ANCHOR_Q + N_TEST_Q,
                           n_items=N_ITEMS)
    m = np.asarray(ce.full_matrix(jnp.arange(N_ANCHOR_Q + N_TEST_Q)))
    noisy = jnp.asarray(m) + 1.2 * jax.random.normal(jax.random.PRNGKey(9), m.shape)
    fields = {k: np.asarray(getattr(ce, k)) for k in convert.SYNTHETIC_CE_FIELDS}
    fields.update(gamma=ce.gamma, sigma=ce.sigma)
    return dict(ce=ce, tce=convert.synthetic_ce(fields, device="cpu"), m=m,
                test_q=np.arange(N_ANCHOR_Q, N_ANCHOR_Q + N_TEST_Q),
                # an imperfect first stage: the noisy exact order a query
                cand_order=np.asarray(jax.lax.top_k(noisy, N_ITEMS)[1]))


def _tokens(ce):
    return (j_lexical_signatures(ce.i_emb, seed=3), j_lexical_signatures(ce.q_emb, seed=3))


# ---- first-stage providers ------------------------------------------------


@pytest.mark.parametrize("seed,n_terms", [(0, 8), (3, 8), (5, 4)])
def test_lexical_signatures_match(dom, seed, n_terms):
    ce, tce = dom["ce"], dom["tce"]
    for jemb, temb in ((ce.i_emb, tce.i_emb), (ce.q_emb, tce.q_emb)):
        want = j_lexical_signatures(np.asarray(jemb), n_terms=n_terms, seed=seed)
        got = lexical_signatures(np.asarray(jemb), n_terms=n_terms, seed=seed)
        assert got.dtype == np.int32 and np.array_equal(got, want)
    # the port's own embeddings (drawn within a few ulp of JAX's) land on
    # the same tokens almost everywhere
    same = lexical_signatures(tce.i_emb, seed=seed) == j_lexical_signatures(ce.i_emb, seed=seed)
    assert same.mean() > 0.99


def _bm25_dense(bm, qids):
    """The reference provider's (B, N) scores (its own weights, numpy)."""
    toks = bm.query_tokens[qids]
    qtf = np.zeros((qids.size, bm.vocab), np.float32)
    np.add.at(qtf, (np.repeat(np.arange(qids.size), toks.shape[1]), toks.ravel()), 1.0)
    qtf[:, bm.pad_id] = 0.0
    s = qtf @ bm._w.T
    s[:, bm.n_valid:] = -np.inf
    return s


@pytest.mark.parametrize("n_valid,k", [(None, 32), (350, 64)])
def test_bm25_order_matches(dom, n_valid, k):
    """Weights within fp32 rounding of the reference's; the shortlist in
    the reference's order (ties to the lower position) up to near-ties the
    comparator accepts, never a position past ``n_valid``; stats counted."""
    corpus, queries = _tokens(dom["ce"])
    jbm = jcand.BM25Candidates(corpus, queries, n_valid=n_valid)
    tbm = BM25Candidates(corpus, queries, n_valid=n_valid, device="cpu")
    assert isinstance(tbm, CandidateGenerator) and tbm.vocab == jbm.vocab
    np.testing.assert_allclose(tbm._w.numpy(), jbm._w, rtol=1e-6, atol=0)
    q = dom["test_q"]
    ji = np.asarray(jbm(jnp.asarray(q), k))
    ti = tbm(torch.as_tensor(q), k)
    ref = _bm25_dense(jbm, q)
    rep = topk_report(ji, np.take_along_axis(ref, ji, 1), ti,
                      np.take_along_axis(ref, ti.numpy().astype(np.int64), 1),
                      torch.from_numpy(ref.copy()))
    assert rep["ok"], rep
    assert (ti < (n_valid or N_ITEMS)).all() and ti.dtype == torch.int32
    assert tbm.stats.requests == 1 and tbm.stats.candidates == len(q) * k


def test_bm25_ties_go_to_the_lower_position():
    """Identical documents score identically: they come out in ascending
    position, as numpy's stable argsort orders them."""
    corpus = np.array([[5, 6], [1, 2], [5, 6], [5, 6], [3, 4], [5, 7]], np.int32)
    queries = np.array([[5, 6]], np.int32)
    got = BM25Candidates(corpus, queries, device="cpu")(torch.tensor([0]), 5)
    want = np.asarray(jcand.BM25Candidates(corpus, queries)(jnp.asarray([0]), 5))
    assert got.tolist() == want.tolist() == [[0, 2, 3, 5, 1]]


def test_oracle_candidates_match(dom):
    exact = dom["m"][N_ANCHOR_Q:]
    for n_valid in (None, 300):
        jo = jcand.OracleCandidates(jnp.asarray(exact), n_valid=n_valid)
        to = OracleCandidates(torch.from_numpy(exact.copy()), n_valid=n_valid)
        ji = np.asarray(jo(jnp.arange(N_TEST_Q), 12))
        ti = to(torch.arange(N_TEST_Q), 12)
        assert np.array_equal(ji, ti.numpy()) and to.stats.candidates == N_TEST_Q * 12


# ---- union and subset payloads ------------------------------------------------


@pytest.mark.parametrize("cand,capacity,n", [
    ([[3, 1, 1, 100], [7, 3, 2, 200]], 8, 256),       # sorted, padded, deduped
    ([[3, 1, 256, 300]], 4, 256),                      # out-of-corpus entries are padding
    ([[9, 4, 7, 1], [2, 8, 5, 0]], 5, 16),             # a union over capacity drops its top
])
def test_union_candidates_match(cand, capacity, n):
    jp, jv, jn = jcand.union_candidates(jnp.asarray(cand), capacity, n)
    tp, tv, tn = union_candidates(torch.as_tensor(cand), capacity, n)
    assert tp.tolist() == np.asarray(jp).tolist() and tp.dtype == torch.int32
    assert tv.tolist() == np.asarray(jv).tolist() and int(tn) == int(jn)


def test_eligibility_matches_after_union(dom):
    cand = torch.as_tensor(dom["cand_order"][N_ANCHOR_Q:, :64].copy())
    want = np.asarray(jcand.candidate_eligibility(jnp.asarray(cand.numpy()), N_ITEMS, False))
    assert np.array_equal(candidate_eligibility(cand, N_ITEMS, per_query=False).numpy(), want)


def _bytes(x):
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            x = x.view(torch.uint8)
        return x.contiguous().numpy().view(np.uint8)
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


@pytest.mark.parametrize("payload", PAYLOADS)
def test_subset_columns_dequantize_bit_equal(dom, payload):
    """Each gathered column dequantizes bit-equal to its source column; the
    padded ones are exact zeros; the bytes equal the reference's subset
    (tile 1, int4 widened to int8)."""
    r = dom["m"][:N_ANCHOR_Q]
    full = quant.as_payload(torch.from_numpy(r.copy()), payload, 64)
    jfull = jquant.as_payload(jnp.asarray(r), payload, 64)
    pos = np.array([0, 5, 63, 64, 130, 131, 383, 0], np.int32)
    valid = np.array([True] * 7 + [False])
    sub = quant.subset_columns(full, torch.as_tensor(pos), torch.as_tensor(valid))
    jsub = jquant.subset_columns(jfull, jnp.asarray(pos), jnp.asarray(valid))

    def deq(p):
        return quant.dequantize(p) if isinstance(p, quant.QuantizedRanc) else p.float()

    assert torch.equal(deq(sub)[:, :7], deq(full)[:, pos[:7]])
    assert not deq(sub)[:, 7].any()
    if isinstance(sub, quant.QuantizedRanc):
        assert (sub.tile, sub.code_dtype) == (jsub.tile, jsub.code_dtype) == (
            1, "int8" if payload == "int4" else payload)
        assert np.array_equal(_bytes(sub.codes), _bytes(jsub.codes))
        assert np.array_equal(sub.scales.numpy(), np.asarray(jsub.scales))
    else:
        assert np.array_equal(_bytes(sub), _bytes(jsub))


# ---- gumbel_at and the oracles ----------------------------------------------


def test_gumbel_at_is_bit_equal_to_blocked_gumbel():
    key = prng.PRNGKey(11)
    cols = torch.tensor([700, 3, 3, 128, 127, 0, 255, 699, 40, 512])
    field = sampling.blocked_gumbel(key, 9, 701)
    for row_offset in (0, 4):
        got = sampling.gumbel_at(key, 9 - row_offset, cols, row_offset=row_offset)
        assert torch.equal(got, field[row_offset:][:, cols])


def test_gumbel_at_matches_the_reference():
    """Threefry's integer bits of every touched block are the reference's;
    the Gumbel floats agree within the prng tests' atol."""
    jkey = jax.random.PRNGKey(11)
    key = prng.key_data(np.asarray(jkey))
    cols = np.array([700, 3, 3, 128, 127, 0, 255, 699, 40, 512], np.int32)
    want = np.asarray(jsampling.gumbel_at(jkey, 5, jnp.asarray(cols), row_offset=2))
    got = sampling.gumbel_at(key, 5, torch.as_tensor(cols), row_offset=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GUMBEL_ATOL)
    for row in (2, 6):
        for blk in np.unique(cols // sampling.NOISE_BLOCK):
            jk = jax.random.fold_in(jax.random.fold_in(jkey, row), int(blk))
            bits = np.asarray(jax.random.bits(jk, (sampling.NOISE_BLOCK,))).astype(np.int64)
            tk = prng.fold_in(prng.fold_in(key, row), int(blk))
            assert np.array_equal(prng.block_bits(tk[None], sampling.NOISE_BLOCK)[0].numpy(),
                                  bits)


@pytest.mark.parametrize("oracle,k_m,eps", [("topk", 0, 0.0), ("topk", 5, 0.25),
                                            ("softmax", 0, 0.0), ("softmax", 4, 0.5)])
def test_oracles_match(dom, oracle, k_m, eps):
    exact = dom["m"][N_ANCHOR_Q:]
    jfn = {"topk": jsampling.oracle_topk, "softmax": jsampling.oracle_softmax}[oracle]
    tfn = {"topk": sampling.oracle_topk, "softmax": sampling.oracle_softmax}[oracle]
    jkey = jax.random.PRNGKey(3)
    want = np.asarray(jfn(jkey, jnp.asarray(exact), 16, k_m=k_m, eps=eps))
    got = tfn(prng.key_data(np.asarray(jkey)), torch.from_numpy(exact.copy()), 16, k_m=k_m,
              eps=eps)
    assert got.shape == (N_TEST_Q, 16) and np.array_equal(got.numpy(), want)
    assert all(len(set(r)) == 16 for r in got.tolist())


# ---- subset search -----------------------------------------------------------


@pytest.mark.parametrize("mode,strat,payload,fused", SUBSET_CONFIGS)
def test_subset_equals_masked(dom, mode, strat, payload, fused):
    """engine_search over the gathered sub-payload (pos_map) is bitwise
    equal to the full-corpus search masked to the union: top-k ids and
    scores, anchors and their scores, rounds."""
    cfg = AdaCURConfig(k_anchor=16, n_rounds=4, budget_ce=40, k_retrieve=10, strategy=strat,
                       payload_dtype=payload, payload_tile=64, use_fused_topk=fused,
                       fused_tile=128, loop_mode="unrolled" if mode == "unrolled" else "fori",
                       early_exit_tol=0.4 if mode == "early" else 0.0)
    full = quant.as_payload(torch.from_numpy(dom["m"][:N_ANCHOR_Q].copy()), payload, 64)
    cand = torch.as_tensor(dom["cand_order"][N_ANCHOR_Q:, :64].copy())
    pos, valid, n_sub = union_candidates(cand, 256, N_ITEMS)
    sub = quant.subset_columns(full, pos, valid)
    q, key = torch.as_tensor(dom["test_q"]), prng.PRNGKey(21)
    kw = {} if mode == "unrolled" else dict(n_rounds=cfg.n_rounds)
    rs = engine_search(TabulatedScorer(dom["m"]), sub, q, cfg, key, n_valid_items=n_sub,
                       item_ids=torch.where(valid, pos, -1), pos_map=pos,
                       return_scores=False, **kw)
    rm = engine_search(TabulatedScorer(dom["m"]), full, q, cfg, key, return_scores=False,
                       eligible=candidate_eligibility(cand, N_ITEMS, per_query=False), **kw)
    p = pos.long()
    assert torch.equal(p[rs.topk_idx.long()].to(torch.int32), rm.topk_idx.to(torch.int32))
    assert torch.equal(rs.topk_scores, rm.topk_scores)
    a = rs.anchor_idx.long()
    assert torch.equal(torch.where(a >= 0, p[a.clamp_min(0)], -1), rm.anchor_idx.long())
    assert torch.equal(rs.anchor_scores, rm.anchor_scores)
    assert rs.rounds_done == rm.rounds_done


def _hybrid_cfg(**kw):
    base = dict(k_anchor=16, n_rounds=4, budget_ce=40, k_retrieve=10, strategy="topk",
                loop_mode="fori", use_fused_topk=True, fused_tile=128)
    base.update(kw)
    return base


@pytest.mark.parametrize("payload", ["float32", "int4"])
def test_subset_hybrid_matches_the_reference(dom, payload):
    """The subset-mode retriever (the default mode) over a padded index
    against the reference's: overlap >= 0.99, results inside the union,
    measured CE == plan, the first stage counted."""
    m = dom["m"]
    ji = JIndex.from_r_anc(jnp.asarray(m[:N_ANCHOR_Q]), capacity=400)
    ti = AnchorIndex.from_r_anc(torch.from_numpy(m[:N_ANCHOR_Q].copy()), capacity=400)
    ji, ti = ji.quantize(payload, tile=64), ti.quantize(payload, tile=64)
    exact = m[N_ANCHOR_Q:]
    jh = jcand.HybridRetriever(score_fn=JTab(m), generator=jcand.OracleCandidates(
        jnp.asarray(m)), cfg=JConfig(**_hybrid_cfg()), index=ji, shortlist_k=64)
    scorer = TabulatedScorer(m)
    orc = OracleCandidates(torch.from_numpy(m.copy()))
    th = HybridRetriever(score_fn=scorer, generator=orc, cfg=AdaCURConfig(**_hybrid_cfg()),
                         index=ti, shortlist_k=64)
    assert th.mode == "subset"
    q = dom["test_q"]
    jres = jh.search(jnp.asarray(q), jax.random.PRNGKey(5))
    tres = th.search(torch.as_tensor(q), prng.PRNGKey(5))
    assert topk_overlap(np.asarray(jres.topk_idx), tres.topk_idx) >= 0.99
    union = set(np.argsort(-exact, axis=1, kind="stable")[:, :64].ravel().tolist())
    assert set(tres.topk_idx.flatten().tolist()) <= union
    assert scorer.stats.ce_calls == th.ce_call_plan() * len(q)
    assert orc.stats.requests == 1 and orc.stats.candidates == len(q) * 64


def test_hybrid_validation(dom):
    t = AnchorIndex.from_r_anc(torch.from_numpy(dom["m"][:N_ANCHOR_Q].copy()))
    orc = OracleCandidates(torch.from_numpy(dom["m"].copy()))
    with pytest.raises(ValueError, match="shortlist_k"):
        HybridRetriever(score_fn=TabulatedScorer(dom["m"]), generator=orc,
                        cfg=AdaCURConfig(**_hybrid_cfg()), index=t, shortlist_k=8)
    with pytest.raises(ValueError, match="unknown mode"):
        HybridRetriever(score_fn=TabulatedScorer(dom["m"]), generator=orc,
                        cfg=AdaCURConfig(**_hybrid_cfg()), index=t, shortlist_k=64,
                        mode="nope")


def test_quality_matrix_hybrid_bm25_row(dom):
    """Token data adds the hybrid_bm25 row: the reference's plan, measured
    CE and budget_matched, recall within 0.02 of its row."""
    ce, tce, m = dom["ce"], dom["tce"], dom["m"]
    corpus, queries = _tokens(ce)
    kw = dict(budget=40, n_rounds=4, ks=(1, 10, 20), shortlist_k=96, seed=0)
    jidx = JIndex.from_r_anc(jnp.asarray(m[:N_ANCHOR_Q]))
    tidx = AnchorIndex.from_r_anc(torch.from_numpy(m[:N_ANCHOR_Q].copy()))
    q = dom["test_q"]
    got = harness.quality_matrix(tce, tidx, q, torch.from_numpy(m.copy()), use_fused_topk=True,
                                 corpus_tokens=corpus, query_tokens=queries, **kw)
    assert [r.method for r in got] == ["adacur", "anncur", "rerank_de", "hybrid_de",
                                       "hybrid_bm25"]
    exact = jnp.asarray(m[q])
    cfg = JConfig(k_anchor=20, n_rounds=4, budget_ce=40, strategy="topk", k_retrieve=20,
                  loop_mode="fori")
    want = jharness.evaluate_retriever(
        "hybrid_bm25", jcand.HybridRetriever(
            score_fn=JTab(m), generator=jcand.BM25Candidates(corpus, queries, n_valid=N_ITEMS),
            cfg=cfg, index=jidx, shortlist_k=96, mode="mask"),
        jnp.asarray(q), jax.random.PRNGKey(0), exact=exact,
        qrels=jharness.qrels_from_exact(exact, k=1), ks=(1, 10, 20))
    row = got[-1]
    assert (row.planned_ce, row.measured_ce, row.budget_matched) == (
        want.planned_ce, want.measured_ce, want.budget_matched) == (40, 40, True)
    for k in (1, 10, 20):
        assert abs(row.topk_recall[k] - want.topk_recall[k]) <= 0.02, k


def test_dual_encoder_generator_is_a_candidate_generator(dom):
    tce = dom["tce"]
    assert isinstance(DualEncoderCandidates(tce.q_emb, tce.i_emb), CandidateGenerator)
    assert isinstance(OracleCandidates(torch.zeros((2, 4))), CandidateGenerator)


def test_serve_cli_serves_the_bm25_hybrid(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--fused", "--n-items", "1000", "--requests", "6",
                "--batch", "4", "--first-stage", "bm25"])
    out = capsys.readouterr().out
    assert "first stage: bm25 shortlist_k=800" in out
    assert "served 6 requests (0 errors)" in out
