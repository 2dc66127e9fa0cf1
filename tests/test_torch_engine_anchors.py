"""The port's engine (plain versions, on the CPU) against the JAX engine on
the engine tests' domain (``tests/_torch_domains.py``): retriever-seeded
runs pick the same anchors, ADACUR^No-Split, the searches' stability under
a one-ulp change of the payload, and dict queries.

The retriever-seeded runs use the full (regularized) pinv: the reference's
incremental bordered update amplifies fp32 rounding round over round on
this domain (the port's projects the residual twice and holds under a
one-ulp change), so exact anchor agreement is only asked where both
packages' arithmetic is stable: noise-free runs (``first_round=
"retriever"``, topk strategy) pick the same anchor ids in >= 0.99 of rows.
Other bars as in ``test_torch_engine.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_domains import (  # noqa: E402
    B, BASE, KEY, MODES, check_accounting, engine_domain, run_both)
from repro_torch import convert  # noqa: E402
from repro_torch.core.engine import ce_call_plan, engine_search as t_search  # noqa: E402
from repro_torch.core.scorer import SyntheticScorer  # noqa: E402
from repro_torch.testing import topk_overlap  # noqa: E402

torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core


@pytest.fixture(scope="module")
def domain():
    return engine_domain()


@pytest.mark.parametrize("mode", ["staged-unrolled-fp32-topk", "persistent-fori3-fp32-topk",
                                  "staged-fori3-int8-softmax"])
def test_retriever_seeded_topk_picks_the_same_anchors(domain, mode):
    cfg_kw = {**BASE, **MODES[mode], "first_round": "retriever",
              "incremental_pinv": False, "strategy": "topk"}
    jres, tres, scorer = run_both(domain, cfg_kw, first=domain["first"])
    same = (np.asarray(jres.anchor_idx) == tres.anchor_idx.numpy()).all(axis=1)
    assert same.mean() >= 0.99
    assert topk_overlap(np.asarray(jres.topk_idx), tres.topk_idx) >= 0.99
    check_accounting(cfg_kw, tres, scorer)


def test_no_split_budget_ranks_anchors(domain):
    cfg_kw = dict(k_anchor=40, n_rounds=4, budget_ce=40, split_budget=False,
                  k_retrieve=30, use_fused_topk=True, loop_mode="fori")
    jres, tres, scorer = run_both(domain, cfg_kw)
    assert tres.anchor_idx.shape == (B, 40) and tres.ce_calls == 40
    assert topk_overlap(np.asarray(jres.topk_idx), tres.topk_idx) >= 0.99
    check_accounting(cfg_kw, tres, scorer)


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
