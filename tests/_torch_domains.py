"""Synthetic domains and engine helpers shared by the port's engine tests
(``test_torch_engine*.py``, ``test_torch_adacur.py``, ``test_torch_serve.py``).

A domain is built once from its seed by the port
(``make_synthetic_ce(prng.PRNGKey(seed))``: JAX's cluster ids bit for bit,
its normals within a few ulp in their far tail) and handed to the JAX
package as the same numpy arrays, so both packages score one domain; its
score matrix is the port's ``full_matrix`` of it.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import AdaCURConfig as JConfig
from repro.core.engine import engine_search as j_search
from repro.data.synthetic import SyntheticCE as JSyntheticCE
from repro_torch import convert
from repro_torch.core import prng
from repro_torch.core.engine import ce_call_plan, engine_search as t_search
from repro_torch.core.scorer import SyntheticScorer
from repro_torch.data.synthetic import make_synthetic_ce

# the engine tests' domain, key and base configuration
N_ITEMS, K_Q, B = 2000, 200, 16
BASE = dict(k_anchor=40, n_rounds=4, budget_ce=80, k_retrieve=30, fused_tile=256)
KEY = 3


def synthetic_domain(seed: int, n_queries: int, n_items: int, matrix_rows: int = 0) -> dict:
    """``ce`` (the JAX package's SyntheticCE), ``tce`` (the port's),
    ``fields`` (the numpy arrays both hold) and, for ``matrix_rows`` > 0,
    ``m``: the port's exact scores of queries 0..matrix_rows-1."""
    tce = make_synthetic_ce(prng.PRNGKey(seed), n_queries=n_queries, n_items=n_items,
                            device="cpu")
    fields = {k: getattr(tce, k).numpy() for k in convert.SYNTHETIC_CE_FIELDS}
    ce = JSyntheticCE(**{k: jnp.asarray(v) for k, v in fields.items()},
                      gamma=tce.gamma, sigma=tce.sigma)
    out = dict(ce=ce, tce=tce, fields=dict(fields, gamma=tce.gamma, sigma=tce.sigma))
    if matrix_rows:
        out["m"] = tce.full_matrix(torch.arange(matrix_rows)).numpy()
    return out


def engine_domain() -> dict:
    """Seed 0, N = 2,000, anchor queries 0..199, test queries 200..215, and
    ten noisy-retriever first anchors a test query."""
    d = synthetic_domain(0, K_Q + B, N_ITEMS, K_Q + B)
    m = d["m"]
    noisy = m[K_Q:] + 2.0 * np.random.default_rng(0).standard_normal((B, N_ITEMS))
    first = np.argsort(-noisy, axis=1, kind="stable")[:, :10].astype(np.int32)
    return dict(ce=d["ce"], tce=d["tce"], r_anc=m[:K_Q], q=np.arange(K_Q, K_Q + B),
                first=first, matrix=m)


def run_both(dom, cfg_kw, first=None, n_rounds=None):
    """The JAX engine and the port's on one configuration, key ``KEY``:
    (reference result, port result, the port's recording scorer)."""
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


def check_accounting(cfg_kw, tres, scorer):
    """Measured CE == plan x B, queries in row order, no pair scored twice."""
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
