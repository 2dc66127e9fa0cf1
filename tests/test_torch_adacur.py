"""The port's Algorithm-1 reference ``adacur_search`` (on the CPU) against
the JAX package's, run live on the same inputs.

With a tensor query: the synthetic domain, key and configuration of
``tests/test_torch_engine.py`` (N = 2,000, k_q = 200, B = 16; 40 anchors in
4 rounds, budget 80), built from its seed by the port and handed to the
JAX package (``tests/_torch_domains.py``).  With a DLRM dict
query ``{"dense", "sparse"}``: the retrieval builder's smoke model, its
R_anc built by the port, four contexts, ``n_valid_items`` below the padded
width.  Bars (the reference's own, as in the engine tests): mean top-k
overlap >= 0.99; noise-free retriever-seeded runs with the full pinv pick
the same anchors in >= 0.99 of rows; ``ce_calls`` equals the budget.  At
the retrieval step's configuration on the DLRM smoke model, both packages
go non-finite (the smoke item table repeats items), and both stay
finite with ``retrieval_smoke_config``'s wider item table.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AdaCURConfig as JConfig  # noqa: E402
from repro.configs.base import RecSysConfig as JRecSysConfig  # noqa: E402
from repro.core.adacur import adacur_search as j_search  # noqa: E402
from repro.models.recsys import dlrm as j_dlrm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.shapes import RECSYS_SHAPES  # noqa: E402
from repro_torch.core.adacur import adacur_search as t_search, query_batch  # noqa: E402
from repro_torch.core.scorer import SyntheticScorer  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.recsys import dlrm, embedding  # noqa: E402
from repro_torch.testing import topk_overlap  # noqa: E402
from _torch_domains import BASE, B, K_Q, KEY, N_ITEMS, engine_domain  # noqa: E402
from test_torch_recsys import retrieval_smoke_config  # noqa: E402


@pytest.fixture(scope="module")
def domain():
    return engine_domain()


def _key():
    return jax.random.PRNGKey(KEY), convert.key(np.asarray(jax.random.PRNGKey(KEY)))


CONFIGS = {
    "topk": dict(),
    "softmax": dict(strategy="softmax"),
    "random": dict(strategy="random"),
    "epsilon": dict(round_epsilon=0.2),
    "no-split": dict(budget_ce=40, split_budget=False),
    "padded": dict(),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_adacur_search_matches_jax(domain, name):
    kw = {k: v for k, v in BASE.items() if k != "fused_tile"}
    kw.update(CONFIGS[name])
    jkey, tkey = _key()
    n_valid = N_ITEMS - 300 if name == "padded" else None
    jres = j_search(domain["ce"].score_fn(), jnp.asarray(domain["r_anc"]),
                    jnp.asarray(domain["q"]), JConfig(**kw), jkey, n_valid_items=n_valid)
    scorer = SyntheticScorer(domain["tce"])
    tres = t_search(scorer, convert.r_anc(domain["r_anc"], device="cpu"),
                    torch.as_tensor(domain["q"]), convert.config(kw), tkey,
                    n_valid_items=n_valid)
    assert tres.topk_idx.shape == tuple(jres.topk_idx.shape)
    assert torch.isfinite(tres.topk_scores).all()
    assert topk_overlap(np.asarray(jres.topk_idx), tres.topk_idx) >= 0.99
    assert tres.ce_calls == jres.ce_calls == kw["budget_ce"]
    assert scorer.stats.ce_calls == kw["budget_ce"] * B
    if n_valid is not None:
        assert int(tres.anchor_idx.max()) < n_valid and int(tres.topk_idx.max()) < n_valid


def test_retriever_seeded_anchors_match_jax(domain):
    kw = dict(k_anchor=40, n_rounds=4, budget_ce=80, k_retrieve=30,
              first_round="retriever", incremental_pinv=False)
    jkey, tkey = _key()
    jres = j_search(domain["ce"].score_fn(), jnp.asarray(domain["r_anc"]),
                    jnp.asarray(domain["q"]), JConfig(**kw), jkey,
                    first_anchors=jnp.asarray(domain["first"]))
    tres = t_search(SyntheticScorer(domain["tce"]),
                    convert.r_anc(domain["r_anc"], device="cpu"), torch.as_tensor(domain["q"]),
                    convert.config(kw), tkey, first_anchors=torch.as_tensor(domain["first"]))
    same = (np.asarray(jres.anchor_idx) == tres.anchor_idx.numpy()).all(axis=1)
    assert same.mean() >= 0.99
    assert topk_overlap(np.asarray(jres.topk_idx), tres.topk_idx) >= 0.99


def test_dlrm_dict_query_matches_jax():
    cfg = retrieval_smoke_config()
    jcfg = JRecSysConfig(**dataclasses.asdict(cfg))
    jparams, _ = j_dlrm.init_dlrm(jax.random.PRNGKey(0), jcfg)
    params = convert.dlrm_params(jax.tree.map(np.asarray, jparams), device="cpu")
    n_cand, b = 900, 4
    anchors = steps.recsys_inputs(cfg, 100, seed=2, device="cpu")
    r_anc = steps.anchor_scores(params, cfg, anchors, n_cand)          # (100, 1024)
    query = steps.recsys_inputs(cfg, b, seed=3, device="cpu")
    jquery = {k: jnp.asarray(v.numpy()) for k, v in query.items()}
    kw = {k: v for k, v in BASE.items() if k != "fused_tile"}
    jkey, tkey = _key()
    jres = j_search(lambda q, idx: j_dlrm.score_candidates(jparams, q["dense"], q["sparse"],
                                                           idx, jcfg),
                    jnp.asarray(r_anc.numpy()), jquery, JConfig(**kw), jkey,
                    n_valid_items=n_cand)
    seen = []

    def sf(q, idx):
        assert q is query, "the query must reach score_fn untouched"
        seen.append(idx.numel())
        return dlrm.score_candidates(params, q["dense"], q["sparse"], idx, cfg)

    tres = t_search(sf, r_anc, query, convert.config(kw), tkey, n_valid_items=n_cand)
    assert sum(seen) == kw["budget_ce"] * b
    assert tres.topk_idx.shape == (b, kw["k_retrieve"])
    assert int(tres.topk_idx.max()) < n_cand
    assert topk_overlap(np.asarray(jres.topk_idx), tres.topk_idx) >= 0.99


@pytest.mark.parametrize("item_table", ["smoke", "retrieval_smoke"])
def test_smoke_item_table_breaks_algorithm_1_in_both_packages(item_table):
    """Why the retrieval tests widen the item table.  At ``smoke_config`` the
    item table (field 0) has 100 rows, 512 padded, and ids are taken modulo
    512, so candidates j and j + 512 are one item with equal R_anc columns.
    Algorithm 1 at the retrieval step's configuration then samples
    duplicated anchor columns and its bordered pinv goes non-finite, in
    both packages on the same inputs: in most rows of the reference, in
    fewer of the port's (its bordered update projects the residual twice,
    the reference's once), not always the same ones, since the solves are
    singular and rounding decides.  Before that the two agree (the same
    anchors in rounds 1 and 2).  With ``retrieval_smoke_config``'s 2,048-row
    item table both stay finite."""
    cfg = registry.smoke_config("dlrm-mlperf")
    if item_table == "retrieval_smoke":
        cfg = retrieval_smoke_config()
    jcfg = JRecSysConfig(**dataclasses.asdict(cfg))
    jparams, _ = j_dlrm.init_dlrm(jax.random.PRNGKey(0), jcfg)
    params = convert.dlrm_params(jax.tree.map(np.asarray, jparams), device="cpu")
    n_cand, b = 1000, 4
    anchors = steps.recsys_inputs(cfg, steps.K_Q, seed=2, device="cpu")
    r_anc = steps.anchor_scores(params, cfg, anchors, n_cand)          # (500, 1024)
    shared = torch.equal(r_anc[:, :n_cand - 512], r_anc[:, 512:n_cand])
    assert shared == (item_table == "smoke")
    query = steps.recsys_inputs(cfg, b, seed=3, device="cpu")
    kw = dataclasses.asdict(steps.RETRIEVAL_CFG)
    jkey, tkey = _key()
    jres = j_search(lambda q, idx: j_dlrm.score_candidates(jparams, q["dense"], q["sparse"],
                                                           idx, jcfg),
                    jnp.asarray(r_anc.numpy()),
                    {k: jnp.asarray(v.numpy()) for k, v in query.items()},
                    JConfig(**kw), jkey, n_valid_items=n_cand)
    tres = t_search(lambda q, idx: dlrm.score_candidates(params, q["dense"], q["sparse"],
                                                         idx, cfg),
                    r_anc, query, convert.config(kw), tkey, n_valid_items=n_cand)
    k2 = 2 * kw["k_anchor"] // kw["n_rounds"]
    assert (np.asarray(jres.anchor_idx)[:, :k2] == tres.anchor_idx[:, :k2].numpy()).all()
    j_bad = int((~np.isfinite(np.asarray(jres.approx_scores))).any(axis=1).sum())
    t_bad = int((~torch.isfinite(tres.approx_scores)).any(dim=1).sum())
    if item_table == "smoke":
        assert j_bad > b // 2 and t_bad > 0, (j_bad, t_bad)
    else:
        assert j_bad == t_bad == 0
        assert topk_overlap(np.asarray(jres.topk_idx), tres.topk_idx) >= 0.99


def test_query_batch_follows_the_reference_rule():
    q = {"sparse": torch.zeros((3, 26)), "dense": torch.zeros((5, 13))}
    assert query_batch(q) == 5                      # first leaf by sorted key
    assert query_batch(q, batch=2) == 2
    assert query_batch(q, first_anchors=torch.zeros((7, 4)), batch=2) == 7
    assert query_batch([torch.zeros((4, 1)), torch.zeros((9,))]) == 4
    assert query_batch(torch.zeros((6,))) == 6


def test_retrieval_shape_is_the_reference_one():
    shape = RECSYS_SHAPES["retrieval_cand"]
    assert (shape.batch, shape.n_candidates) == (1, 1_000_000)
    assert embedding.padded_rows(shape.n_candidates) == 1_000_448
