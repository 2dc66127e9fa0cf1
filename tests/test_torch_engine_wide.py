"""The port's engine (plain versions, on the CPU) against the JAX engine at
the quality matrix's configuration (budget 200, 100 anchors in 5 rounds,
k_retrieve 100) over a wider domain built from its seed by the port
(``tests/_torch_domains.py``), and the witness that the reference's own
bordered pinv update loses the estimate there (ROADMAP queue 3)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_domains import (  # noqa: E402
    B, K_Q, KEY, check_accounting, run_both, synthetic_domain)
from repro.configs.base import AdaCURConfig as JConfig  # noqa: E402
from repro.core.engine import engine_search as j_search  # noqa: E402
from repro_torch.testing import topk_overlap  # noqa: E402

torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core


# The quality matrix's configuration (budget 200, 100 anchors in 5 rounds,
# k_retrieve 100) over a wider domain: key 7, as chip_smoke's card-vs-CPU
# phase, at N = 4,096.
MATRIX = dict(k_anchor=100, n_rounds=5, budget_ce=200, k_retrieve=100, strategy="topk",
              loop_mode="fori", use_fused_topk=True)


@pytest.fixture(scope="module")
def wide():
    d = synthetic_domain(7, K_Q + B, 4096, K_Q + B)
    return dict(ce=d["ce"], tce=d["tce"], r_anc=d["m"][:K_Q], q=np.arange(K_Q, K_Q + B),
                matrix=d["m"])


def test_quality_matrix_config_matches_jax_with_the_full_pinv(wide):
    """The 100-anchor, 5-round search against the reference with the full
    pinv, the configuration chip_smoke's card-vs-CPU phase gates: the
    engine's bar (top-k overlap >= 0.99) and exact CE accounting."""
    cfg_kw = dict(MATRIX, incremental_pinv=False)
    jres, tres, scorer = run_both(wide, cfg_kw)
    assert tres.topk_idx.shape == (B, 100) and torch.isfinite(tres.topk_scores).all()
    assert topk_overlap(np.asarray(jres.topk_idx), tres.topk_idx) >= 0.99
    check_accounting(cfg_kw, tres, scorer)


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
