"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU and ``nvcc`` and skip elsewhere
(the decision is made inside the fixture, never at import).  On the card
(``--noconftest``: the suite's conftest imports jax, which the port's
machine need not have):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.approx_topk.ops import approx_topk_op  # noqa: E402
from repro_torch.kernels.approx_topk.persistent import persistent_round_op  # noqa: E402
from repro_torch.kernels.approx_topk.quant import quantize_ranc  # noqa: E402
from repro_torch.kernels.approx_topk.ref import dense_scores  # noqa: E402
from repro_torch.testing import assert_topk_agree  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, b=40, k_q=96, n=9000, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    e = torch.randn((b, k_q), generator=g, device=dev)
    r = torch.randn((k_q, n), generator=g, device=dev)
    noise = torch.rand((b, n), generator=g, device=dev)
    mask = torch.rand((b, n), generator=g, device=dev) < 0.2
    anchors = torch.randint(0, n, (b, 30), generator=g, device=dev, dtype=torch.int32)
    return e, r, noise, mask, anchors


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("k", [1, 20, 100])
def test_approx_topk_kernel_matches_plain(dev, dtype, k):
    e, r, noise, mask, anchors = _inputs(dev)
    pay = r if dtype == "float32" else quantize_ranc(r)
    before = kernels.launch_counts()["approx_topk"]
    kv, ki = approx_topk_op(e, pay, anchors, k, noise=noise, mask=mask, n_valid=8500)
    assert kernels.launch_counts()["approx_topk"] == before + 1
    pv, pi = approx_topk_op(e, pay, anchors, k, noise=noise, mask=mask, n_valid=8500,
                            impl="torch")
    assert_topk_agree(ki, kv, pi, pv,
                      dense_scores(e, pay, anchors, noise=noise, mask=mask, n_valid=8500))


def test_underfilled_rows_are_distinct_and_ascending(dev):
    e, r, _, _, _ = _inputs(dev)
    mask = torch.ones((e.shape[0], r.shape[1]), dtype=torch.bool, device=dev)
    mask[1, [5, 700, 8000]] = False
    _, ki = approx_topk_op(e, r, None, 8, mask=mask)
    assert ki[0].tolist() == list(range(8))
    assert sorted(ki[1, :3].tolist()) == [5, 700, 8000]
    assert ki[1, 3:].tolist() == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_persistent_kernel_is_two_staged_calls(dev, dtype):
    e, r, noise, mask, anchors = _inputs(dev, seed=1)
    pay = r if dtype == "float32" else quantize_ranc(r)
    (sv, si), (pv, pi) = persistent_round_op(e, pay, k_sample=20, k_prov=50,
                                             anchors=anchors, noise=noise, prov_mask=mask)
    av, ai = approx_topk_op(e, pay, anchors, 20, noise=noise)
    bv, bi = approx_topk_op(e, pay, None, 50, mask=mask)
    for x, y in ((sv, av), (si, ai), (pv, bv), (pi, bi)):
        assert torch.equal(x, y)
    (qv, qi), (rv, ri) = persistent_round_op(e, pay, k_sample=20, k_prov=50, anchors=anchors,
                                             noise=noise, prov_mask=mask, impl="torch")
    assert_topk_agree(si, sv, qi, qv, dense_scores(e, pay, anchors, noise=noise))
    assert_topk_agree(pi, pv, ri, rv, dense_scores(e, pay, mask=mask))


def test_engine_on_the_card_matches_the_cpu(dev):
    """The early-exit persistent loop (software-pipelined, both lists per
    sweep) on the card and on the CPU.  It uses the full regularized pinv,
    which is stable under rounding (``test_torch_engine.py::
    test_full_pinv_search_is_stable_under_rounding``): the incremental
    bordered update amplifies fp32 rounding, and with it the card's and the
    CPU's top-k overlap came out at 0.9885 on a domain of 100 anchor
    queries."""
    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core import prng
    from repro_torch.core.engine import engine_search
    from repro_torch.core.index import AnchorIndex
    from repro_torch.core.scorer import SyntheticScorer
    from repro_torch.data.synthetic import make_synthetic_ce
    from repro_torch.testing import topk_overlap

    ce = make_synthetic_ce(prng.PRNGKey(4), n_queries=232, n_items=3000, device="cpu")
    idx = AnchorIndex.build(ce.score_block, torch.arange(200), torch.arange(3000))
    cfg = AdaCURConfig(k_anchor=40, n_rounds=8, budget_ce=80, k_retrieve=30,
                       loop_mode="fori", use_fused_topk=True, round_kernel="persistent",
                       early_exit_tol=0.5, incremental_pinv=False)
    q = torch.arange(200, 232)
    cpu = engine_search(SyntheticScorer(ce), idx.r_anc, q, cfg, prng.PRNGKey(3))
    kernels.reset_launches()
    card = engine_search(SyntheticScorer(ce.to(dev)), idx.r_anc.to(dev), q.to(dev), cfg,
                         prng.PRNGKey(3))
    assert card.rounds_done == cpu.rounds_done < cfg.n_rounds
    assert kernels.launch_counts() == {"approx_topk": 1, "persistent_round": card.rounds_done}
    assert topk_overlap(cpu.topk_idx, card.topk_idx) >= 0.99
    assert np.isfinite(card.topk_scores.cpu().numpy()).all()
