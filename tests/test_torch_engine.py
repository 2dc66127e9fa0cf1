"""The port's engine (plain versions, on the CPU) against the JAX engine on
one small domain built from its seed by the port and handed to the JAX
package (``tests/_torch_domains.py``): every round kernel, loop mode and
payload.  The retriever-seeded, stability and dict-query tests are in
``test_torch_engine_anchors.py``, the 100-anchor configuration in
``test_torch_engine_wide.py`` (split so the suite's workers share them).

Bars (the reference's own, ``tests/test_engine.py``):
- mean top-``k_retrieve`` overlap >= 0.99 per configuration;
- measured CE calls == ``ce_call_plan(cfg, rounds_done) * B`` exactly, and
  no row scores a pair twice.

Both engines see the same key, so the same noise bits."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_domains import (  # noqa: E402
    B, BASE, KEY, MODES, check_accounting, engine_domain, run_both)
from repro_torch import convert  # noqa: E402
from repro_torch.core.engine import engine_search as t_search  # noqa: E402
from repro_torch.core.scorer import SyntheticScorer  # noqa: E402
from repro_torch.testing import topk_overlap  # noqa: E402

torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core


@pytest.fixture(scope="module")
def domain():
    return engine_domain()


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_jax(domain, mode):
    cfg_kw = dict(BASE, **MODES[mode])
    n_rounds = 3 if "fori3" in mode else None
    jres, tres, scorer = run_both(domain, cfg_kw, n_rounds=n_rounds)
    assert int(jres.rounds_done) == tres.rounds_done
    assert tres.topk_idx.shape == (B, 30) and torch.isfinite(tres.topk_scores).all()
    assert topk_overlap(np.asarray(jres.topk_idx), tres.topk_idx) >= 0.99
    check_accounting(cfg_kw, tres, scorer)


def test_runtime_rounds_need_fori(domain):
    with pytest.raises(ValueError, match="fori"):
        t_search(SyntheticScorer(domain["tce"]), convert.r_anc(domain["r_anc"], device="cpu"),
                 torch.as_tensor(domain["q"]), convert.config(dict(BASE)),
                 convert.key(np.asarray(jax.random.PRNGKey(KEY))), n_rounds=2)
