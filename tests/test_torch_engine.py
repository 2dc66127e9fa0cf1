"""The port's engine (plain versions, on the CPU) against the JAX engine on
one small domain built by the JAX package and carried across.

Bars (the reference's own, ``tests/test_engine.py``):
- mean top-``k_retrieve`` overlap >= 0.99 per configuration;
- noise-free runs (``first_round="retriever"``, topk strategy) pick the
  same anchor ids in >= 0.99 of rows;
- measured CE calls == ``ce_call_plan(cfg, rounds_done) * B`` exactly, and
  no row scores a pair twice.

The retriever-seeded runs use the full (regularized) pinv: the reference's
incremental bordered update amplifies fp32 rounding round over round on
this domain (the port's projects the residual twice and holds under a
one-ulp change), so exact anchor agreement is only asked where both
packages' arithmetic is stable.  Both engines see the same key, so the same noise
bits."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AdaCURConfig as JConfig  # noqa: E402
from repro.core.engine import engine_search as j_search  # noqa: E402
from repro.data.synthetic import make_synthetic_ce  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.engine import ce_call_plan, engine_search as t_search  # noqa: E402
from repro_torch.core.scorer import SyntheticScorer  # noqa: E402
from repro_torch.testing import topk_overlap  # noqa: E402

N_ITEMS, K_Q, B = 2000, 200, 16
BASE = dict(k_anchor=40, n_rounds=4, budget_ce=80, k_retrieve=30, fused_tile=256)
KEY = 3


@pytest.fixture(scope="module")
def domain():
    ce = make_synthetic_ce(jax.random.PRNGKey(0), n_queries=K_Q + B, n_items=N_ITEMS)
    m = np.asarray(ce.full_matrix(jnp.arange(K_Q + B)))
    fields = {k: np.asarray(getattr(ce, k)) for k in convert.SYNTHETIC_CE_FIELDS}
    fields.update(gamma=ce.gamma, sigma=ce.sigma)
    noisy = m[K_Q:] + 2.0 * np.random.default_rng(0).standard_normal((B, N_ITEMS))
    first = np.argsort(-noisy, axis=1, kind="stable")[:, :10].astype(np.int32)
    return dict(ce=ce, tce=convert.synthetic_ce(fields, device="cpu"), r_anc=m[:K_Q],
                q=np.arange(K_Q, K_Q + B), first=first)


def _run_both(dom, cfg_kw, first=None, n_rounds=None):
    jcfg = JConfig(**cfg_kw)
    kw = {} if n_rounds is None else dict(n_rounds=n_rounds)
    jres = j_search(dom["ce"].score_fn(), jnp.asarray(dom["r_anc"]), jnp.asarray(dom["q"]),
                    jcfg, jax.random.PRNGKey(KEY),
                    first_anchors=None if first is None else jnp.asarray(first), **kw)
    scorer = SyntheticScorer(dom["tce"], record_pairs=True)
    tres = t_search(scorer, convert.r_anc(dom["r_anc"], device="cpu"),
                    torch.as_tensor(dom["q"]),
                    convert.config(cfg_kw), convert.key(np.asarray(jax.random.PRNGKey(KEY))),
                    first_anchors=None if first is None else torch.as_tensor(first), **kw)
    return jres, tres, scorer


def _check_accounting(cfg_kw, tres, scorer):
    cfg = convert.config(cfg_kw)
    assert scorer.stats.ce_calls == ce_call_plan(cfg, tres.rounds_done) * B
    pairs = [[] for _ in range(B)]
    for q, idx in scorer.call_log:
        for row in range(B):
            assert q[row] == K_Q + row
            pairs[row] += idx[row].tolist()
    for row in pairs:
        assert len(row) == len(set(row)), "a row scored a pair twice"


# every value of {staged, persistent} x {unrolled, fori(runtime n_rounds),
# early exit} x {fp32, int8, bf16, fp8, int4} x {topk, softmax} at least
# once, plus dense
MODES = {
    "staged-unrolled-fp32-topk": dict(use_fused_topk=True),
    "persistent-unrolled-int8-softmax": dict(
        use_fused_topk=True, round_kernel="persistent", payload_dtype="int8",
        strategy="softmax"),
    "staged-fori3-int8-softmax": dict(
        use_fused_topk=True, loop_mode="fori", payload_dtype="int8", strategy="softmax"),
    "persistent-fori3-fp32-topk": dict(
        use_fused_topk=True, loop_mode="fori", round_kernel="persistent"),
    "staged-early-fp32-softmax": dict(
        use_fused_topk=True, loop_mode="fori", early_exit_tol=0.5, strategy="softmax"),
    "persistent-early-int8-topk": dict(
        use_fused_topk=True, loop_mode="fori", early_exit_tol=0.5,
        round_kernel="persistent", payload_dtype="int8"),
    "dense-unrolled-fp32-topk": dict(use_fused_topk=False),
    # the bf16, fp8 and packed-int4 payloads, staged and persistent
    "staged-fori3-bf16-topk": dict(
        use_fused_topk=True, loop_mode="fori", payload_dtype="bfloat16"),
    "persistent-unrolled-fp8-softmax": dict(
        use_fused_topk=True, round_kernel="persistent", payload_dtype="fp8",
        strategy="softmax"),
    "staged-unrolled-int4-topk": dict(use_fused_topk=True, payload_dtype="int4"),
    "persistent-early-int4-topk": dict(
        use_fused_topk=True, loop_mode="fori", early_exit_tol=0.5,
        round_kernel="persistent", payload_dtype="int4"),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_jax(domain, mode):
    cfg_kw = dict(BASE, **MODES[mode])
    n_rounds = 3 if "fori3" in mode else None
    jres, tres, scorer = _run_both(domain, cfg_kw, n_rounds=n_rounds)
    assert int(jres.rounds_done) == tres.rounds_done
    assert tres.topk_idx.shape == (B, 30) and torch.isfinite(tres.topk_scores).all()
    assert topk_overlap(np.asarray(jres.topk_idx), tres.topk_idx) >= 0.99
    _check_accounting(cfg_kw, tres, scorer)


@pytest.mark.parametrize("mode", ["staged-unrolled-fp32-topk", "persistent-fori3-fp32-topk",
                                  "staged-fori3-int8-softmax"])
def test_retriever_seeded_topk_picks_the_same_anchors(domain, mode):
    cfg_kw = {**BASE, **MODES[mode], "first_round": "retriever",
              "incremental_pinv": False, "strategy": "topk"}
    jres, tres, scorer = _run_both(domain, cfg_kw, first=domain["first"])
    same = (np.asarray(jres.anchor_idx) == tres.anchor_idx.numpy()).all(axis=1)
    assert same.mean() >= 0.99
    assert topk_overlap(np.asarray(jres.topk_idx), tres.topk_idx) >= 0.99
    _check_accounting(cfg_kw, tres, scorer)


def test_no_split_budget_ranks_anchors(domain):
    cfg_kw = dict(k_anchor=40, n_rounds=4, budget_ce=40, split_budget=False,
                  k_retrieve=30, use_fused_topk=True, loop_mode="fori")
    jres, tres, scorer = _run_both(domain, cfg_kw)
    assert tres.anchor_idx.shape == (B, 40) and tres.ce_calls == 40
    assert topk_overlap(np.asarray(jres.topk_idx), tres.topk_idx) >= 0.99
    _check_accounting(cfg_kw, tres, scorer)


def test_runtime_rounds_need_fori(domain):
    with pytest.raises(ValueError, match="fori"):
        t_search(SyntheticScorer(domain["tce"]), convert.r_anc(domain["r_anc"], device="cpu"),
                 torch.as_tensor(domain["q"]), convert.config(dict(BASE)),
                 convert.key(np.asarray(jax.random.PRNGKey(KEY))), n_rounds=2)


def _search_and_nudged(dom, cfg):
    """The port's search on the payload and on the payload with a relative
    change of 1e-7 (about one fp32 ulp) to every entry."""
    r = dom["r_anc"]
    nudged = r * (1 + 1e-7 * np.random.default_rng(1).standard_normal(r.shape))
    key = convert.key(np.asarray(jax.random.PRNGKey(KEY)))
    q = torch.as_tensor(dom["q"])
    return (t_search(SyntheticScorer(dom["tce"]),
                     convert.r_anc(x.astype(np.float32), device="cpu"), q, cfg, key)
            for x in (r, nudged))


def test_full_pinv_search_is_stable_under_rounding(domain):
    """A relative change of 1e-7 (about one fp32 ulp) to every payload entry
    leaves the early-exit persistent search with the full pinv unchanged:
    the same rounds and the same top-k.  Card-vs-CPU checks of that loop
    (``tests/test_torch_cuda.py``, ``chip_smoke.py``) rely on it, since the
    card's cuBLAS/cuSOLVER round differently from the CPU's BLAS/LAPACK."""
    cfg = convert.config(dict(k_anchor=40, n_rounds=8, budget_ce=80, k_retrieve=30,
                              loop_mode="fori", use_fused_topk=True,
                              round_kernel="persistent", early_exit_tol=0.5,
                              incremental_pinv=False))
    a, b = _search_and_nudged(domain, cfg)
    assert a.rounds_done == b.rounds_done < cfg.n_rounds
    assert topk_overlap(a.topk_idx, b.topk_idx) == 1.0


@pytest.mark.parametrize("round_kernel", ["staged", "persistent"])
def test_incremental_pinv_search_is_stable_under_rounding(domain, round_kernel):
    """The same one-ulp change leaves the default search, with the
    incremental pinv, unchanged too: the bordered update projects the new
    columns' residual off the old span twice.  With one projection (the
    reference's) this change moves the top-k on this domain, and the
    card's rounding moved chip_smoke's card-vs-CPU overlap below 0.99."""
    cfg = convert.config(dict(k_anchor=40, n_rounds=4, budget_ce=80, k_retrieve=30,
                              loop_mode="fori", use_fused_topk=True,
                              round_kernel=round_kernel))
    a, b = _search_and_nudged(domain, cfg)
    assert topk_overlap(a.topk_idx, b.topk_idx) == 1.0


@pytest.mark.parametrize("batch", [None, B])
def test_dict_query_gives_the_ids_of_the_tensor_query(domain, batch):
    """A query pytree reaches score_fn untouched, and B comes from the
    first leaf or ``batch=`` (the reference's rule), so a dict wrapping the
    query ids searches exactly as the bare ids do."""
    cfg = convert.config(dict(BASE, use_fused_topk=True))
    key = convert.key(np.asarray(jax.random.PRNGKey(KEY)))
    q = torch.as_tensor(domain["q"])
    r = convert.r_anc(domain["r_anc"], device="cpu")
    bare = t_search(SyntheticScorer(domain["tce"]), r, q, cfg, key)
    inner = SyntheticScorer(domain["tce"])

    def scorer(query, idx):
        assert set(query) == {"ids", "z"} and query["ids"] is q
        return inner(query["ids"], idx)

    wrapped = t_search(scorer, r, {"z": torch.zeros((B, 3)), "ids": q}, cfg, key, batch=batch)
    assert torch.equal(wrapped.topk_idx, bare.topk_idx)
    assert torch.equal(wrapped.anchor_idx, bare.anchor_idx)
    assert inner.stats.ce_calls == ce_call_plan(cfg) * B


# The quality matrix's configuration (budget 200, 100 anchors in 5 rounds,
# k_retrieve 100) over a wider domain: key 7, as chip_smoke's card-vs-CPU
# phase, at N = 4,096.
MATRIX = dict(k_anchor=100, n_rounds=5, budget_ce=200, k_retrieve=100, strategy="topk",
              loop_mode="fori", use_fused_topk=True)


@pytest.fixture(scope="module")
def wide():
    n_items = 4096
    ce = make_synthetic_ce(jax.random.PRNGKey(7), n_queries=K_Q + B, n_items=n_items)
    m = np.asarray(ce.full_matrix(jnp.arange(K_Q + B)))
    fields = {k: np.asarray(getattr(ce, k)) for k in convert.SYNTHETIC_CE_FIELDS}
    fields.update(gamma=ce.gamma, sigma=ce.sigma)
    return dict(ce=ce, tce=convert.synthetic_ce(fields, device="cpu"), r_anc=m[:K_Q],
                q=np.arange(K_Q, K_Q + B), matrix=m)


def test_quality_matrix_config_matches_jax_with_the_full_pinv(wide):
    """The 100-anchor, 5-round search against the reference with the full
    pinv, the configuration chip_smoke's card-vs-CPU phase gates: the
    engine's bar (top-k overlap >= 0.99) and exact CE accounting."""
    cfg_kw = dict(MATRIX, incremental_pinv=False)
    jres, tres, scorer = _run_both(wide, cfg_kw)
    assert tres.topk_idx.shape == (B, 100) and torch.isfinite(tres.topk_scores).all()
    assert topk_overlap(np.asarray(jres.topk_idx), tres.topk_idx) >= 0.99
    _check_accounting(cfg_kw, tres, scorer)


def test_reference_bordered_update_loses_the_estimate_at_100_anchors(wide):
    """A witness of a reference-side fault (ROADMAP queue 3).  On the anchors
    the reference's own 100-anchor, 5-round search picked (condition ~2e4),
    its fp32 bordered update (``block_pinv_extend_static``: a Gram solve,
    which squares the residual's condition) replayed over the same five
    blocks gives an estimate whose rerank top-100 shares < 0.9 of its ids
    with the float64 pinv's (0.75 here); the fp32 full pinv shares >= 0.99
    (1.0).  The port runs the same estimator; its bordered update, which
    projects the residual twice, loses less of it (0.93 here) but is no
    cure.  So a one-ulp change of the payload moves the top-k of both
    engines at this configuration, and card-vs-CPU checks of it use the
    full pinv."""
    from repro.core import cur as j_cur
    from repro_torch.core import cur as t_cur

    jres = j_search(wide["ce"].score_fn(), jnp.asarray(wide["r_anc"]), jnp.asarray(wide["q"]),
                    JConfig(**MATRIX), jax.random.PRNGKey(KEY))
    anc = np.asarray(jres.anchor_idx)                                  # (B, 100)
    r = wide["r_anc"]
    cols = np.stack([r[:, row] for row in anc])                        # (B, k_q, 100)
    c = np.take_along_axis(wide["matrix"][wide["q"]], anc, axis=1)     # (B, 100)
    k_s, k_i = 20, 100

    def bordered(init, extend, zeros, upd):
        p = upd(zeros((B, k_i, K_Q)), (slice(None), slice(0, k_s)), init(cols[:, :, :k_s]))
        a = upd(zeros((B, K_Q, k_i)), (slice(None), slice(None), slice(0, k_s)),
                cols[:, :, :k_s])
        for st in range(k_s, k_i, k_s):
            p = extend(a, p, cols[:, :, st:st + k_s], st)
            a = upd(a, (slice(None), slice(None), slice(st, st + k_s)), cols[:, :, st:st + k_s])
        return np.asarray(p)

    j_p = bordered(lambda x: jax.vmap(j_cur.incremental_pinv_init)(jnp.asarray(x)),
                   jax.vmap(j_cur.block_pinv_extend_static, in_axes=(0, 0, 0, None)),
                   lambda s: jnp.zeros(s, jnp.float32), lambda x, i, v: x.at[i].set(v))

    def t_upd(x, i, v):
        x = x.clone()
        x[i] = torch.as_tensor(np.asarray(v))
        return x

    t_p = bordered(lambda x: t_cur.incremental_pinv_init(torch.as_tensor(x)),
                   lambda a, p, b, st: t_cur.block_pinv_extend_static(a, p, torch.as_tensor(b), st),
                   torch.zeros, t_upd)
    full = np.asarray(jax.vmap(j_cur.pinv)(jnp.asarray(cols)))
    exact = np.linalg.pinv(cols.astype(np.float64))

    r64 = r.astype(np.float64)
    rows = np.arange(B)[:, None]

    def rerank_top(p):
        s = np.einsum("bk,bkq->bq", c.astype(np.float64), p.astype(np.float64)) @ r64
        s[rows, anc] = -np.inf
        return np.argsort(-s, axis=1, kind="stable")[:, :100]

    ref = rerank_top(exact)
    assert topk_overlap(ref, rerank_top(j_p)) < 0.9
    assert topk_overlap(ref, rerank_top(full)) >= 0.99
    assert topk_overlap(ref, rerank_top(t_p)) >= topk_overlap(ref, rerank_top(j_p))
