"""The port's AnchorIndex build and AdaCURService on the CPU.

``AnchorIndex.build`` over a SyntheticCE built from its seed by the port
and handed to the JAX package (``tests/_torch_domains.py``) matches ``repro.core.index.build_r_anc`` within atol 1e-5 (scores
are O(1); the port computes the background as one matrix product, the
reference as an einsum, so the sums round differently)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.index import AnchorIndex as JIndex, build_r_anc  # noqa: E402
from _torch_domains import synthetic_domain  # noqa: E402
from repro_torch.configs.base import AdaCURConfig  # noqa: E402
from repro_torch.core.engine import AdaCURRetriever, ce_call_plan  # noqa: E402
from repro_torch.core.index import AnchorIndex  # noqa: E402
from repro_torch.core.scorer import SyntheticScorer, TabulatedScorer  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

N_ITEMS, K_Q = 1200, 100


@pytest.fixture(scope="module")
def carried():
    d = synthetic_domain(1, K_Q + 20, N_ITEMS)
    return d["ce"], d["tce"]


def _cfg(**kw):
    return AdaCURConfig(k_anchor=20, n_rounds=4, budget_ce=40, k_retrieve=10,
                        loop_mode="fori", use_fused_topk=True, fused_tile=256, **kw)


def test_index_build_matches_reference(carried):
    ce, tce = carried
    ref = np.asarray(build_r_anc(ce.score_block, jnp.arange(K_Q), jnp.arange(N_ITEMS),
                                 block_rows=32))
    idx = AnchorIndex.build(tce.score_block, torch.arange(K_Q), torch.arange(N_ITEMS),
                            block_rows=32)
    assert idx.capacity == N_ITEMS and idx.n_items == N_ITEMS and idx.k_q == K_Q
    np.testing.assert_allclose(idx.r_anc.numpy(), ref, atol=1e-5, rtol=0)
    # the int8 re-encoding is bit-equal to the reference's on the same matrix
    jq = JIndex.from_r_anc(jnp.asarray(ref)).quantize("int8")
    tq = AnchorIndex.from_r_anc(torch.from_numpy(ref.copy())).quantize("int8")
    assert np.array_equal(np.asarray(jq.r_anc.codes), tq.r_anc.codes.numpy())
    assert np.array_equal(np.asarray(jq.r_anc.scales), tq.r_anc.scales.numpy())
    assert tq.payload_nbytes == N_ITEMS * K_Q + 4 * (-(-N_ITEMS // 512))


@pytest.mark.parametrize("round_kernel,payload", [("staged", "float32"),
                                                  ("persistent", "int8"),
                                                  ("persistent", "int4")])
def test_service_answers_with_a_padded_partial_bucket(carried, round_kernel, payload):
    _, tce = carried
    idx = AnchorIndex.build(tce.score_block, torch.arange(K_Q), torch.arange(N_ITEMS))
    cfg = _cfg(round_kernel=round_kernel, payload_dtype=payload)
    scorer = SyntheticScorer(tce)
    svc = serve.AdaCURService(retriever=AdaCURRetriever.from_index(idx, scorer, cfg),
                              max_batch=8, max_wait_s=3600.0)
    out = []
    for qid in range(K_Q, K_Q + 11):
        out += svc.submit(serve.RetrievalRequest(query_id=qid)) or []
    assert len(out) == 8 and svc.poll() == []
    out += svc.flush()                        # 3 stragglers -> bucket 4
    assert [r.query_id for r in out] == list(range(K_Q, K_Q + 11))
    assert all(r.status == "ok" and r.item_ids.shape == (10,) for r in out)
    assert [b["bucket"] for b in svc.batch_log] == [8, 4]
    plan = ce_call_plan(cfg)
    assert [b["ce_calls"] for b in svc.batch_log] == [plan * 8, plan * 4]
    assert out[0].measured_ce_calls == plan
    assert all(np.isfinite(r.scores).all() for r in out)


def test_service_turns_a_raising_scorer_into_error_responses(carried):
    _, tce = carried
    idx = AnchorIndex.build(tce.score_block, torch.arange(K_Q), torch.arange(N_ITEMS))

    class Broken(TabulatedScorer):
        def __call__(self, query, item_idx):
            raise RuntimeError("scorer down")

    svc = serve.AdaCURService(retriever=AdaCURRetriever.from_index(
        idx, Broken(np.zeros((K_Q + 20, N_ITEMS))), _cfg()), max_batch=4)
    out = serve.drive(svc, 6, qid_range=(K_Q, K_Q + 20))
    assert len(out) == 6
    assert all(r.status == "error" and "scorer down" in r.error and r.item_ids is None
               for r in out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "fp8", "int4"])
def test_serve_cli_runs_on_the_cpu(dtype, capsys):
    """Every payload serves; the coded and bf16 ones print their bytes
    against fp32's."""
    serve.main(["--device", "cpu", "--fused", "--payload-dtype", dtype, "--n-items", "1500",
                "--requests", "5", "--batch", "4", "--budget", "40", "--rounds", "4"])
    out = capsys.readouterr().out
    assert "served 5 requests (0 errors)" in out
    if dtype != "float32":
        assert f"payload {dtype}: " in out and "(fp32 would be 3.0 MB)" in out


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "fp8", "int4"])
def test_index_quantize_matches_reference(dtype):
    """``AnchorIndex.quantize`` re-encodes to the reference's bytes, and
    ``payload_nbytes`` counts packed int4 at half a byte a column."""
    r = np.random.default_rng(4).standard_normal((K_Q, 1001)).astype(np.float32)
    jq = JIndex.from_r_anc(jnp.asarray(r)).quantize(dtype)
    tq = AnchorIndex.from_r_anc(torch.from_numpy(r)).quantize(dtype)
    assert tq.payload_dtype == dtype and tq.r_anc.shape == (K_Q, 1001)
    jcodes = jq.r_anc.codes if dtype != "bfloat16" else jq.r_anc
    tcodes = tq.r_anc.codes if dtype != "bfloat16" else tq.r_anc
    assert np.array_equal(np.asarray(jcodes).view(np.uint8),
                          tcodes.contiguous().view(torch.uint8).numpy())
    assert tq.payload_nbytes == jq.payload_nbytes
    per_col = {"bfloat16": 2, "int8": 1, "fp8": 1, "int4": 0.5}[dtype]
    scales = 0 if dtype == "bfloat16" else 4 * 2
    assert tq.payload_nbytes == K_Q * int(np.ceil(1001 * per_col)) + scales
