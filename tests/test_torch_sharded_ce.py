"""The port's ``DeviceCEScorer`` and the serve CLI's ``--mesh``.

- ``DeviceCEScorer`` on one device against the reference's
  ``DeviceCEScorer`` and the port's ``CrossEncoderScorer`` (the same search
  ids), on ``ce-tiny`` cut to 2 layers and ``d_model`` 64, with the
  reference's weights carried across by ``convert.py``;
- under a 1 x 2 mesh (a gloo world of 2 CPU ranks, spawned once for the
  module; this file run as ``python tests/test_torch_sharded_ce.py worker
  DIR``): the sharded engine with the CE device-resident returns the
  single-device ids, and every pair is scored exactly once, the item-shard
  pad rows counted apart;
- the serve CLI under ``torchrun --nproc-per-node 4 ... --mesh 2x2 --device
  cpu`` serves every request with the planned CE calls, and refuses
  ``--cache`` under ``--mesh``, a batch whose buckets do not divide over the
  data shards, and a mesh whose size is not the world's;
- a scorer fault on one rank of a sharded ``AdaCURService`` (a 2 x 1 gloo
  world, this file run as ``python tests/test_torch_sharded_ce.py fault
  RANK DIR``) ends every rank within seconds: rank 0 answers each request
  once, with the error, and the follower's ``follow`` raises.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
N_ITEMS, N_Q = 256, 24
ENGINE_CFG = dict(k_anchor=12, n_rounds=4, budget_ce=24, k_retrieve=10, loop_mode="fori")
QUERIES = (16, 21)          # 5 rows: 15 pairs a round, so the 1 x 2 mesh pads one row
KEY = 7
SPAWN_TIMEOUT = 180
FAULT_REQUESTS, FAULT_TIMEOUT = 24, 120


def worker(out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core import prng
    from repro_torch.core.engine import make_sharded_engine
    from repro_torch.core.index import AnchorIndex
    from repro_torch.core.scorer import DeviceCEScorer
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_serving_mesh

    torch.set_num_threads(1)
    out = Path(out_dir)
    mesh = make_serving_mesh(1, 2, device="cpu")
    d = np.load(out / "domain.npz")
    blob = torch.load(out / "ce.pt", weights_only=False)
    scorer = DeviceCEScorer(blob["params"], blob["cfg"],
                            query_token_fn=lambda q: d["query_tokens"][q],
                            len_buckets=(32, 64), flash_block=(16, 16))
    index = AnchorIndex.from_r_anc(torch.as_tensor(d["m"][:16])).with_item_tokens(
        torch.as_tensor(d["item_tokens"])).shard(mesh)
    cfg = AdaCURConfig(**ENGINE_CFG)
    run = make_sharded_engine(scorer, cfg, mesh)
    q_tok = scorer.tokenize_queries(np.arange(*QUERIES))
    res = run(index.r_anc, q_tok, prng.PRNGKey(KEY), item_tokens=index.item_tokens)
    out_res = dict(topk_idx=res.topk_idx, topk_scores=res.topk_scores,
                   rounds=int(res.rounds_done), ce_calls=scorer.stats.ce_calls,
                   batch_pad=scorer.stats.batch_pad)
    try:
        serve.main(["--mesh", "2x2", "--device", "cpu", "--batch", "8"])
        out_res["cli_world_error"] = None
    except SystemExit as e:
        out_res["cli_world_error"] = str(e)
    torch.save(out_res, out / f"rank{dist.get_rank()}.pt")
    dist.barrier()
    dist.destroy_process_group()


def fault_worker(fault_rank: int, out_dir: str) -> None:
    """One rank of a 2 x 1 sharded service whose scorer raises on rank
    ``fault_rank``'s second call (the first batch's round 1)."""
    import time

    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core.engine import AdaCURRetriever
    from repro_torch.core.index import AnchorIndex
    from repro_torch.core.scorer import TabulatedScorer
    from repro_torch.launch.faults import FaultPlan, FaultyScorer, ScorerFault
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.serve import AdaCURService, drive

    torch.set_num_threads(1)
    mesh = make_serving_mesh(2, 1, device="cpu")
    rank = dist.get_rank()
    m = torch.randn((40, 512), generator=torch.Generator().manual_seed(0))
    plan = FaultPlan([ScorerFault(call_k=2)]) if rank == fault_rank else None
    svc = AdaCURService(retriever=AdaCURRetriever.from_index(
        AnchorIndex.from_r_anc(m[:16]).shard(mesh),
        FaultyScorer(TabulatedScorer(m), plan), AdaCURConfig(**ENGINE_CFG)), max_batch=8)
    out, t0 = {}, time.monotonic()
    if rank == 0:
        served = drive(svc, FAULT_REQUESTS, qid_range=(16, 40))
        svc.stop_followers()
        out.update(query_ids=[r.query_id for r in served], statuses=[r.status for r in served],
                   errors=[r.error for r in served])
    else:
        try:
            out["batches"] = svc.follow()
        except Exception as e:  # noqa: BLE001 — the raise is the result
            out["raised"] = f"{type(e).__name__}: {e}"
    out.update(seconds=time.monotonic() - t0, mesh_error=svc.mesh_error,
               world_alive=dist.is_initialized())
    torch.save(out, Path(out_dir) / f"fault{fault_rank}_rank{rank}.pt")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ != "__main__":
    torch = pytest.importorskip("torch")
    torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp  # noqa: E402


def _lm_cfg(vocab):
    from repro.configs import registry
    from repro.configs.base import replace

    return replace(registry.CE_TINY, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   head_dim=16, d_ff=128, vocab_size=vocab, dtype="float32", remat=False)


@pytest.fixture(scope="module")
def ce(tmp_path_factory):
    from repro.data.synthetic import make_zeshel_like
    from repro.models import cross_encoder
    from repro_torch import convert
    from repro_torch.configs.base import LMConfig
    from repro_torch.core.scorer import CrossEncoderScorer

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ds = make_zeshel_like(0, n_items=N_ITEMS, n_queries=N_Q, item_len=12, query_len=8)
    jcfg = _lm_cfg(ds.vocab_size)
    jparams, _ = cross_encoder.init_cross_encoder(jax.random.PRNGKey(0), jcfg)
    cfg = LMConfig(**dataclasses.asdict(jcfg))
    params = convert.lm_params(jax.tree.map(np.asarray, jparams), device="cpu")
    host = CrossEncoderScorer(params, cfg, ds.pair_tokens, micro_batch=16,
                              flash_block=(16, 16), len_buckets=(32, 64))
    m = host._host(np.arange(N_Q), np.tile(np.arange(N_ITEMS), (N_Q, 1))).numpy()
    host.reset_stats()
    out = tmp_path_factory.mktemp("sharded_ce")
    np.savez(out / "domain.npz", m=m, item_tokens=np.asarray(ds.item_tokens),
             query_tokens=np.asarray(ds.query_tokens))
    torch.save(dict(params=params, cfg=cfg), out / "ce.pt")
    from repro_torch.testing import run_world

    ranks = run_world([sys.executable, __file__, "worker", str(out)], 2, SPAWN_TIMEOUT,
                      env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    for r, (rc, o, e) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}\n{o}\n{e[-4000:]}"
    yield dict(ds=ds, jcfg=jcfg, jparams=jparams, cfg=cfg, params=params, host=host, m=m,
               ranks=[torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)])
    torch.set_num_threads(n)


def _port_device_scorer(ce):
    from repro_torch.core.scorer import DeviceCEScorer

    return DeviceCEScorer(ce["params"], ce["cfg"],
                          query_token_fn=lambda q: np.asarray(ce["ds"].query_tokens)[q],
                          item_tokens=ce["ds"].item_tokens, len_buckets=(32, 64),
                          flash_block=(16, 16))


def _port_single(ce, scorer, query):
    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core import prng
    from repro_torch.core.engine import make_engine

    return make_engine(scorer, AdaCURConfig(**ENGINE_CFG))(
        torch.as_tensor(ce["m"][:16]), query, prng.PRNGKey(KEY))


def test_device_ce_scorer_matches_the_reference_and_the_host_scorer(ce):
    from repro.configs.base import AdaCURConfig as JConfig
    from repro.core.engine import make_engine as j_make_engine
    from repro.core.scorer import DeviceCEScorer as JDeviceCE
    from repro_torch.core.engine import ce_call_plan

    q = np.arange(*QUERIES)
    jsc = JDeviceCE(ce["jparams"], ce["jcfg"],
                    query_token_fn=lambda i: np.asarray(ce["ds"].query_tokens)[i],
                    item_tokens=ce["ds"].item_tokens, len_buckets=(32, 64),
                    flash_block=(16, 16))
    jres = j_make_engine(jsc, JConfig(**ENGINE_CFG))(
        jnp.asarray(ce["m"][:16]), jsc.tokenize_queries(jnp.asarray(q)),
        jax.random.PRNGKey(KEY))
    sc = _port_device_scorer(ce)
    res = _port_single(ce, sc, sc.tokenize_queries(torch.as_tensor(q)))
    host = _port_single(ce, ce["host"], torch.as_tensor(q))
    np.testing.assert_array_equal(res.topk_idx.numpy(), np.asarray(jres.topk_idx))
    np.testing.assert_array_equal(res.topk_idx.numpy(), host.topk_idx.numpy())
    np.testing.assert_allclose(res.topk_scores.numpy(), np.asarray(jres.topk_scores),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(res.topk_scores.numpy(), host.topk_scores.numpy(),
                               rtol=1e-5, atol=1e-5)
    planned = ce_call_plan(sc_cfg(), res.rounds_done) * len(q)
    assert sc.stats.ce_calls == planned == jsc.stats.ce_calls
    assert sc.stats.batch_pad == 0


def sc_cfg():
    from repro_torch.configs.base import AdaCURConfig

    return AdaCURConfig(**ENGINE_CFG)


def test_device_ce_scorer_scores_the_pairs_it_is_handed(ce):
    sc = _port_device_scorer(ce)
    q_tok = sc.tokenize_queries(np.array([3, 5]))
    idx = torch.tensor([[0, 7, 255], [1, 2, 3]], dtype=torch.int32)
    got = sc(q_tok, idx)
    ref = ce["host"](torch.tensor([3, 5]), idx)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    assert sc.stats.ce_calls == 6 and sc.n_traces == 1


def test_device_ce_under_a_mesh_returns_the_single_device_ids(ce):
    sc = _port_device_scorer(ce)
    ref = _port_single(ce, sc, sc.tokenize_queries(np.arange(*QUERIES)))
    for rank, got in enumerate(ce["ranks"]):
        assert torch.equal(got["topk_idx"], ref.topk_idx), rank
        np.testing.assert_allclose(got["topk_scores"].numpy(), ref.topk_scores.numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert got["rounds"] == ref.rounds_done


def test_device_ce_under_a_mesh_scores_every_pair_once_without_pad_rows(ce):
    from repro_torch.core.engine import ce_call_plan

    ranks = ce["ranks"]
    planned = ce_call_plan(sc_cfg(), ranks[0]["rounds"]) * (QUERIES[1] - QUERIES[0])
    assert sum(r["ce_calls"] for r in ranks) == planned
    assert ranks[0]["ce_calls"] == planned and ranks[1]["ce_calls"] == 0   # item shard 0 counts
    # 15 pairs a round split over 2 item shards: one pad row each round
    assert ranks[0]["batch_pad"] == ranks[0]["rounds"]


def test_cli_refuses_a_mesh_the_world_does_not_have(ce):
    for got in ce["ranks"]:
        assert "needs 4 ranks, but the world has 2" in got["cli_world_error"]


@pytest.mark.parametrize("argv,msg", [
    (["--mesh", "2x2", "--scorer", "real-ce", "--cache", "--batch", "8"], "drop --cache"),
    (["--mesh", "2x2", "--batch", "12"], "multiple of 8"),
    (["--mesh", "2by2"], "DATAxITEMS"),
])
def test_cli_refusals_under_a_mesh(argv, msg):
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match=msg):
        serve.main(argv + ["--device", "cpu"])


def test_cli_serves_under_torchrun_on_a_2x2_mesh(tmp_path):
    """Rank 0 builds the index into ``--index-path`` and saves it, then every
    rank loads its columns (``AnchorIndex.load(path, mesh)``) and serves."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "repro_torch.launch.serve", "--mesh", "2x2", "--device", "cpu", "--fused",
         "--n-items", "2000", "--requests", "16", "--batch", "8",
         "--index-path", str(tmp_path / "index")],
        env=env, capture_output=True, text=True, timeout=SPAWN_TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "saved AnchorIndex" in out.stdout, out.stdout
    assert "[adacur/mesh 2x2] served 16 requests (0 errors)" in out.stdout, out.stdout
    assert "measured: 3200 CE calls over 4 ranks" in out.stdout, out.stdout


@pytest.fixture(scope="module")
def faults(tmp_path_factory):
    """Both fault worlds (the fault on rank 0, on rank 1), run side by side."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.testing import run_world

    out = tmp_path_factory.mktemp("sharded_faults")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with ThreadPoolExecutor(2) as pool:
        worlds = list(pool.map(lambda fr: run_world(
            [sys.executable, __file__, "fault", str(fr), str(out)], 2, FAULT_TIMEOUT, env=env),
            (0, 1)))
    for fr, ranks in enumerate(worlds):
        for r, (rc, o, e) in enumerate(ranks):
            assert rc == 0, f"fault on rank {fr}: rank {r} exited {rc}\n{o}\n{e[-4000:]}"
    return {fr: [torch.load(out / f"fault{fr}_rank{r}.pt", weights_only=False)
                 for r in range(2)] for fr in (0, 1)}


@pytest.mark.parametrize("fault_rank", [0, 1])
def test_a_fault_on_one_rank_ends_every_rank_with_one_error_per_request(faults, fault_rank):
    leader, follower = faults[fault_rank]
    # every request answered once, in submission order, each with the error
    assert len(leader["query_ids"]) == FAULT_REQUESTS
    assert leader["statuses"] == ["error"] * FAULT_REQUESTS
    assert "FaultInjectedError" in leader["errors"][0] or fault_rank == 1
    assert all("torn down" in e for e in leader["errors"][8:])   # later batches: no search
    # the world is gone on both ranks, and neither waited for a timeout
    assert leader["mesh_error"] is not None and follower["mesh_error"] is not None
    assert "raised" in follower and not leader["world_alive"] and not follower["world_alive"]
    if fault_rank == 1:
        assert "FaultInjectedError" in follower["raised"]
    assert max(leader["seconds"], follower["seconds"]) < 30


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "worker":
    sys.path.insert(0, str(ROOT / "src"))
    worker(sys.argv[2])
elif __name__ == "__main__" and len(sys.argv) == 4 and sys.argv[1] == "fault":
    sys.path.insert(0, str(ROOT / "src"))
    fault_worker(int(sys.argv[2]), sys.argv[3])
