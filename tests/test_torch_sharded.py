"""The port's sharded engine and sharded AnchorIndex over a gloo world of
2 (data) x 2 (items) = 4 CPU ranks, spawned once for the module.

Each rank runs every case (this file, run as ``python
tests/test_torch_sharded.py worker DIR``) and saves its results; the tests
then hold them:

- against the port's single-device engine, BITWISE (``topk_idx``,
  ``topk_scores``, ``anchor_idx``, ``rounds_done``) for the six
  loop-mode / strategy / payload configurations of the reference's
  ``check_engine_spmd_parity``, the persistent round kernel on int4 and fp8
  (``check_engine_spmd_persistent``) and ``eligible`` masks
  (``check_engine_spmd_eligible``); measured CE calls summed over the
  ranks equal ``ce_call_plan(cfg, rounds) x B`` and no row scores a pair
  twice;
- against the reference's ``make_sharded_engine``, run live in a
  subprocess on a 2 x 2 ``jax.sharding.Mesh`` of forced host devices;
- for the index: ``shard`` alignment and co-sharded codes/scales, the
  sharded ``topk`` against the port's and the reference's unsharded
  ``topk`` at a ragged ``n_valid``, ``load(path, mesh)`` of indexes the
  reference saved (each rank gets exactly its columns and reads only
  them), and sharded mutation bit-equal to unsharded mutation, then shard.

The domain is the reference's ``_engine_domain`` (tests/test_multidevice.py):
24 anchor queries, 8 test queries, N = 1,024: 512 columns an item shard and
4 query rows a data shard.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
N_AQ, N_TQ, N = 24, 8, 1024
KEY = 11
SPAWN_TIMEOUT = 240

BASE = dict(k_anchor=16, n_rounds=4, budget_ce=32, k_retrieve=10, use_fused_topk=True,
            fused_tile=128, payload_tile=128)


def _parity_cfg(mode, strat, payload, **kw):
    return dict(BASE, strategy=strat, payload_dtype=payload,
                loop_mode="unrolled" if mode == "unrolled" else "fori",
                early_exit_tol=0.3 if mode == "early" else 0.0, **kw)


# check_engine_spmd_parity's six configurations, then the persistent kernel
# (check_engine_spmd_persistent) and per-query / union eligible masks
ENGINE_CASES = {
    "fori/topk/float32": _parity_cfg("fori", "topk", "float32"),
    "fori/softmax/float32": _parity_cfg("fori", "softmax", "float32"),
    "fori/random/int8": _parity_cfg("fori", "random", "int8"),
    "unrolled/topk/int8": _parity_cfg("unrolled", "topk", "int8"),
    "early/topk/float32": _parity_cfg("early", "topk", "float32"),
    "early/softmax/int8": _parity_cfg("early", "softmax", "int8"),
    "persistent/fori/int4": _parity_cfg("fori", "topk", "int4", round_kernel="persistent"),
    "persistent/early/int4": _parity_cfg("early", "topk", "int4", round_kernel="persistent"),
    "persistent/early/float32": _parity_cfg("early", "topk", "float32",
                                            round_kernel="persistent"),
    "persistent/fori/fp8": _parity_cfg("fori", "softmax", "fp8", round_kernel="persistent"),
    "eligible/topk/float32": dict(_parity_cfg("fori", "topk", "float32"), k_retrieve=8),
    "eligible/random/int8": dict(_parity_cfg("fori", "random", "int8"), k_retrieve=8),
    "eligible-union/topk/float32": dict(_parity_cfg("fori", "topk", "float32"), k_retrieve=8),
    "dense/softmax/float32": dict(_parity_cfg("fori", "softmax", "float32"),
                                  use_fused_topk=False, round_epsilon=0.25),
}
# the configurations run live through the reference's make_sharded_engine
REFERENCE_CASES = ("fori/topk/float32", "fori/softmax/float32", "early/softmax/int8")
# saved by the reference, loaded by the port with a mesh: (payload, tile, capacity)
SAVED = {"float32": ("float32", None, 1024), "int8": ("int8", 128, 1024),
         "int4-unaligned": ("int4", 128, 1000)}
MUTATIONS = ("float32", "int8", "int4")


def _eligible(m):
    """The reference's imperfect first stage: a noisy top-96 per query."""
    rng = np.random.default_rng(3)
    noisy = m[N_AQ:] + 1.5 * rng.standard_normal((N_TQ, N))
    cand = np.argsort(-noisy, axis=1, kind="stable")[:, :96]
    per_query = np.zeros((N_TQ, N), bool)
    np.put_along_axis(per_query, cand, True, axis=1)
    return per_query, per_query.any(0)


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------


def worker(out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core import prng
    from repro_torch.core.engine import AdaCURRetriever, make_sharded_engine
    from repro_torch.core.index import AnchorIndex
    from repro_torch.core.scorer import TabulatedScorer
    from repro_torch.launch.mesh import make_serving_mesh

    torch.set_num_threads(1)
    out = Path(out_dir)
    mesh = make_serving_mesh(2, 2, device="cpu")
    rank = dist.get_rank()
    d = np.load(out / "domain.npz")
    m, q = d["m"], torch.as_tensor(d["test_q"])
    base = AnchorIndex.from_r_anc(torch.as_tensor(d["m"][:N_AQ]))
    sharded = base.shard(mesh)
    key = prng.PRNGKey(KEY)
    res = {"engine": {}, "index": {}}

    for name, kw in ENGINE_CASES.items():
        cfg = AdaCURConfig(**kw)
        scorer = TabulatedScorer(m, record_pairs=True)
        run = make_sharded_engine(scorer, cfg, mesh)
        eligible = None
        if name.startswith("eligible-union"):
            eligible = torch.as_tensor(d["union"])
        elif name.startswith("eligible"):
            eligible = torch.as_tensor(d["per_query"])
        r = run(sharded.r_anc, q, key, eligible=eligible)
        res["engine"][name] = dict(
            topk_idx=r.topk_idx, topk_scores=r.topk_scores, anchor_idx=r.anchor_idx,
            anchor_scores=r.anchor_scores, rounds=int(r.rounds_done),
            ce_calls=scorer.stats.ce_calls, log=scorer.call_log)

    # -- the index ---------------------------------------------------------
    r24 = torch.as_tensor(d["r_idx"])
    e_q = torch.as_tensor(d["e_q"])
    for payload in ("float32", "int8"):
        idx = AnchorIndex.from_r_anc(r24, capacity=1024)
        if payload == "int8":
            idx = idx.quantize("int8", tile=16)
        sh = idx.shard(mesh)
        v, i = sh.topk(e_q, 10, tile=128)
        pay = sh.r_anc
        res["index"][f"topk/{payload}"] = dict(
            vals=v, ids=i, capacity=sh.capacity, local=sh.local_capacity,
            item_axes=sh.item_axes, offset=sh.item_offset,
            codes=getattr(pay, "codes", pay), scales=getattr(pay, "scales", None))
        # the placement survives mutation
        mut = sh.add_items(torch.arange(1000, 1010), cols=torch.zeros(24, 10))
        res["index"][f"mutated_axes/{payload}"] = mut._item_sharding()[1]

    # an under-filled shard: 515 valid items, so item shard 1 holds 3 and
    # k = 10 > 3; then 6, so every valid item is on shard 0 and the list
    # ends in masked ids
    for n_valid in (515, 6):
        sh = AnchorIndex.from_r_anc(r24[:, :n_valid], capacity=1024).shard(mesh)
        v, i = sh.topk(e_q, 10, tile=128)
        res["index"][f"underfilled/{n_valid}"] = dict(vals=v, ids=i)

    for name, (payload, tile, cap) in SAVED.items():
        path = str(out / f"saved_{name}")
        from repro_torch.checkpoint import checkpointer as ck

        loaded = AnchorIndex.load(path, mesh=mesh)
        whole = AnchorIndex.load(path, device="cpu").shard(mesh)
        pay, ref = loaded.r_anc, whole.r_anc
        same = (torch.equal(getattr(pay, "codes", pay), getattr(ref, "codes", ref))
                and (tile is None or torch.equal(pay.scales, ref.scales))
                and torch.equal(loaded.item_ids, whole.item_ids)
                and int(loaded.n_valid) == int(whole.n_valid))
        ckpt = ck.Checkpointer(path)
        ckpt.restore(0, device="cpu")
        full_bytes = ckpt.bytes_read
        loaded_bytes = _bytes_read_by_load(path, mesh)
        res["index"][f"load/{name}"] = dict(
            offset=loaded.item_offset, local=loaded.local_capacity,
            capacity=loaded.capacity, codes=getattr(pay, "codes", pay),
            scales=getattr(pay, "scales", None), item_ids=loaded.item_ids,
            equals_load_then_shard=same, bytes_read=loaded_bytes, full_bytes=full_bytes)

    for payload in MUTATIONS:
        cols = torch.as_tensor(m[:N_AQ, :6])
        idx = AnchorIndex.from_r_anc(torch.as_tensor(d["m"][:N_AQ, :1000]), capacity=1024)
        if payload != "float32":
            idx = idx.quantize(payload, tile=128)

        def mutate(ix):
            ix = ix.remove_items(torch.arange(30, 40)).add_items(torch.arange(5000, 5006),
                                                                 cols=cols)
            return ix.remove_items(torch.tensor([600, 601, 999]))

        a = mutate(idx).shard(mesh)
        b = mutate(idx.shard(mesh))
        grown_a = idx.with_capacity(2048).shard(mesh)
        grown_b = idx.shard(mesh).with_capacity(2048)
        res["index"][f"mutation/{payload}"] = dict(
            same=_same_slab(a, b), same_grown=_same_slab(grown_a, grown_b),
            n_valid=int(b.n_valid), axes=b._item_sharding()[1])
        # the sharded engine over the mutated sharded index, external ids out
        cfg = AdaCURConfig(**dict(BASE, loop_mode="fori", payload_dtype=payload))

        class Wrap(TabulatedScorer):
            def __call__(self, query, item_idx):
                item_idx = torch.where(item_idx >= 5000, item_idx - 5000, item_idx)
                return super().__call__(query, item_idx)

        single = mutate(idx)
        ra = AdaCURRetriever.from_index(single, Wrap(m), cfg).search(q, key)
        ret = AdaCURRetriever.from_index(b, Wrap(m), cfg)
        rb = ret.search(q, key)
        res["index"][f"mutated_search/{payload}"] = dict(
            sharded=ret._sharded, same_ids=torch.equal(ra.topk_idx, rb.topk_idx),
            same_scores=torch.equal(ra.topk_scores, rb.topk_scores),
            same_external=torch.equal(single.gather_item_ids(ra.topk_idx),
                                      b.gather_item_ids(rb.topk_idx)))

    # a sharded fp32 index quantized at a tile its slabs do not hold whole
    idx = AnchorIndex.from_r_anc(torch.as_tensor(d["m"][:N_AQ, :1000]), capacity=1024)
    q_sh = idx.shard(mesh).quantize("int8", tile=384)
    q_un = idx.quantize("int8", tile=384)
    lo = q_sh.item_offset
    hi = min(lo + q_sh.local_capacity, 1024)
    res["index"]["quantize_realigns"] = dict(
        capacity=q_sh.capacity, local=q_sh.local_capacity,
        same=(hi <= lo) or torch.equal(q_sh.r_anc.codes[:, :hi - lo], q_un.r_anc.codes[:, lo:hi]))

    # the mesh refuses a size the world does not have
    try:
        make_serving_mesh(1, 2, device="cpu")
        res["mesh_error"] = None
    except ValueError as e:
        res["mesh_error"] = str(e)

    torch.save(res, out / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _bytes_read_by_load(path, mesh) -> int:
    """Bytes ``AnchorIndex.load(path, mesh)`` copied off the disk."""
    from repro_torch.checkpoint import checkpointer as ck
    from repro_torch.core.index import AnchorIndex

    seen = []
    restore = ck.Checkpointer.restore

    def spy(self, *a, **kw):
        out = restore(self, *a, **kw)
        seen.append(self.bytes_read)
        return out

    ck.Checkpointer.restore = spy
    try:
        AnchorIndex.load(path, mesh=mesh)
    finally:
        ck.Checkpointer.restore = restore
    return seen[0]


def _same_slab(a, b) -> bool:
    import torch

    pa, pb = a.r_anc, b.r_anc
    if hasattr(pa, "codes"):
        ok = torch.equal(pa.codes, pb.codes) and torch.equal(pa.scales, pb.scales)
    else:
        ok = torch.equal(pa, pb)
    return (ok and torch.equal(a.item_ids, b.item_ids) and int(a.n_valid) == int(b.n_valid)
            and a.capacity == b.capacity)


# ---------------------------------------------------------------------------
# the reference's make_sharded_engine, live (forced host devices)
# ---------------------------------------------------------------------------

REFERENCE_SCRIPT = r"""
import sys, json
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.base import AdaCURConfig
from repro.core.engine import make_sharded_engine
from repro.core.scorer import TabulatedScorer

d = np.load(sys.argv[1] + "/domain.npz")
cases = json.loads(sys.argv[2])
mesh = jax.make_mesh((2, 2), ("data", "items"))
out = {}
for name, kw in cases.items():
    r = make_sharded_engine(TabulatedScorer(d["m"]), AdaCURConfig(**kw), mesh)(
        jnp.asarray(d["m"][:24]), jnp.asarray(d["test_q"]), jax.random.PRNGKey(%d))
    for f in ("topk_idx", "topk_scores", "anchor_idx"):
        out[name + ":" + f] = np.asarray(getattr(r, f))
    out[name + ":rounds"] = np.asarray(int(r.rounds_done))
np.savez(sys.argv[1] + "/reference.npz", **out)
print("OK")
""" % KEY


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------

if __name__ != "__main__":
    torch = pytest.importorskip("torch")
    torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp  # noqa: E402


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from repro.core.index import AnchorIndex as JIndex
    from repro.data.synthetic import make_synthetic_ce

    out = tmp_path_factory.mktemp("sharded")
    ce = make_synthetic_ce(jax.random.PRNGKey(0), n_queries=N_AQ + N_TQ, n_items=N)
    m = np.asarray(ce.full_matrix(jnp.arange(N_AQ + N_TQ)), dtype=np.float32)
    per_query, union = _eligible(m)
    rng = np.random.default_rng(0)
    r_idx = rng.standard_normal((24, 1000)).astype(np.float32)
    e_q = rng.standard_normal((5, 24)).astype(np.float32)
    np.savez(out / "domain.npz", m=m, test_q=np.arange(N_AQ, N_AQ + N_TQ), per_query=per_query,
             union=union, r_idx=r_idx, e_q=e_q)
    for name, (payload, tile, cap) in SAVED.items():
        ix = JIndex.from_r_anc(jnp.asarray(m[:N_AQ, :1000]), capacity=cap)
        if tile is not None:
            ix = ix.quantize(payload, tile=tile)
        ix.save(str(out / f"saved_{name}"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_SCRIPT, str(out),
         json.dumps({k: ENGINE_CASES[k] for k in REFERENCE_CASES})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    from repro_torch.testing import run_world

    t0 = time.monotonic()
    ranks = run_world([sys.executable, __file__, "worker", str(out)], 4, SPAWN_TIMEOUT,
                      env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    spawn_s = time.monotonic() - t0
    try:
        ref_out, ref_err = ref.communicate(timeout=SPAWN_TIMEOUT)
    except subprocess.TimeoutExpired:
        ref.kill()
        ref_out, ref_err = ref.communicate()
    for r, (rc, o, e) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}\n{o}\n{e[-4000:]}"
    assert ref.returncode == 0, f"reference subprocess failed\n{ref_out}\n{ref_err[-4000:]}"
    return dict(out=out, m=m, per_query=per_query, union=union, r_idx=r_idx, e_q=e_q,
                spawn_s=spawn_s, ref=dict(np.load(out / "reference.npz")),
                ranks=[torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)])


def _single(world, name):
    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core import prng
    from repro_torch.core.engine import make_engine
    from repro_torch.core.scorer import TabulatedScorer

    eligible = None
    if name.startswith("eligible-union"):
        eligible = torch.as_tensor(world["union"])
    elif name.startswith("eligible"):
        eligible = torch.as_tensor(world["per_query"])
    return make_engine(TabulatedScorer(world["m"]), AdaCURConfig(**ENGINE_CASES[name]))(
        torch.tensor(world["m"][:N_AQ]), torch.arange(N_AQ, N_AQ + N_TQ),
        prng.PRNGKey(KEY), eligible=eligible)


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_sharded_engine_is_bitwise_the_single_device_engine(world, name):
    ref = _single(world, name)
    for rank, res in enumerate(world["ranks"]):
        got = res["engine"][name]
        for f in ("topk_idx", "topk_scores", "anchor_idx", "anchor_scores"):
            assert torch.equal(got[f], getattr(ref, f)), (name, rank, f)
        assert got["rounds"] == ref.rounds_done, (name, rank)


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_sharded_ce_calls_equal_the_plan_and_no_pair_is_scored_twice(world, name):
    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core.engine import ce_call_plan

    cfg = AdaCURConfig(**ENGINE_CASES[name])
    runs = [res["engine"][name] for res in world["ranks"]]
    rounds = runs[0]["rounds"]
    assert sum(r["ce_calls"] for r in runs) == ce_call_plan(cfg, rounds) * N_TQ
    pairs = {}
    for r in runs:
        for qids, idx in r["log"]:
            for row in range(idx.shape[0]):
                pairs.setdefault(int(qids[row]), []).extend(int(i) for i in idx[row])
    assert sorted(pairs) == list(range(N_AQ, N_AQ + N_TQ))
    for qid, row in pairs.items():
        assert len(row) == len(set(row)), f"query {qid} scored a pair twice"
    if name.startswith("eligible") and not name.startswith("eligible-union"):
        for b, row in enumerate(runs[0]["topk_idx"].numpy()):
            assert world["per_query"][b, row].all(), f"row {b} returned a non-candidate"


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_sharded_engine_matches_the_reference_sharded_engine(world, name):
    ref, got = world["ref"], world["ranks"][0]["engine"][name]
    np.testing.assert_array_equal(got["topk_idx"].numpy(), ref[name + ":topk_idx"])
    np.testing.assert_array_equal(got["anchor_idx"].numpy(), ref[name + ":anchor_idx"])
    np.testing.assert_allclose(got["topk_scores"].numpy(), ref[name + ":topk_scores"],
                               rtol=1e-6, atol=1e-6)
    assert got["rounds"] == int(ref[name + ":rounds"])


@pytest.mark.parametrize("payload", ["float32", "int8"])
def test_sharded_topk_equals_the_unsharded_topk_of_both_packages(world, payload):
    from repro.core.index import AnchorIndex as JIndex
    from repro_torch.core.index import AnchorIndex

    r, e_q = world["r_idx"], world["e_q"]
    port = AnchorIndex.from_r_anc(torch.as_tensor(r), capacity=1024)
    ref = JIndex.from_r_anc(jnp.asarray(r), capacity=1024)
    if payload == "int8":
        port, ref = port.quantize("int8", tile=16), ref.quantize("int8", tile=16)
    pv, pi = port.topk(torch.as_tensor(e_q), 10, tile=128)
    jv, ji = ref.topk(jnp.asarray(e_q), 10, tile=128)
    for rank, res in enumerate(world["ranks"]):
        got = res["index"][f"topk/{payload}"]
        assert torch.equal(got["ids"], pi), rank
        assert torch.equal(got["vals"], pv), rank
        np.testing.assert_array_equal(got["ids"].numpy(), np.asarray(ji))
        np.testing.assert_allclose(got["vals"].numpy(), np.asarray(jv), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n_valid", [515, 6])
def test_underfilled_shards_return_distinct_ascending_masked_ids(world, n_valid):
    """A shard with fewer than k live items contributes its lowest masked
    ids (distinct, at NEG_INF); the merge keeps the global lowest, as the
    port's unsharded topk returns them (the reference's Pallas kernel
    repeats ids there, ROADMAP queue 3)."""
    from repro_torch.core.index import AnchorIndex
    from repro_torch.kernels.approx_topk.select import NEG_INF

    r = torch.as_tensor(world["r_idx"][:, :n_valid])
    pv, pi = AnchorIndex.from_r_anc(r, capacity=1024).topk(torch.as_tensor(world["e_q"]), 10,
                                                            tile=128)
    for rank, res in enumerate(world["ranks"]):
        got = res["index"][f"underfilled/{n_valid}"]
        assert torch.equal(got["ids"], pi) and torch.equal(got["vals"], pv), rank
        for row_ids, row_vals in zip(got["ids"].tolist(), got["vals"].tolist()):
            assert len(set(row_ids)) == 10
            masked = [i for i, v in zip(row_ids, row_vals) if v <= 0.5 * NEG_INF]
            assert masked == sorted(masked) and all(i >= n_valid for i in masked)
            assert len(masked) == max(0, 10 - n_valid)


@pytest.mark.parametrize("payload", ["float32", "int8"])
def test_shard_aligns_capacity_and_coshards_codes_with_scales(world, payload):
    from repro_torch.core.index import AnchorIndex

    whole = AnchorIndex.from_r_anc(torch.as_tensor(world["r_idx"]), capacity=1024)
    if payload == "int8":
        whole = whole.quantize("int8", tile=16)
    offsets = set()
    for rank, res in enumerate(world["ranks"]):
        got = res["index"][f"topk/{payload}"]
        assert got["item_axes"] == ("items",)
        assert res["index"][f"mutated_axes/{payload}"] == ("items",)
        assert got["capacity"] == 1024 and got["local"] == 512
        assert got["offset"] == (rank % 2) * 512     # ranks run row-major over (data, items)
        offsets.add(got["offset"])
        lo, hi = got["offset"], got["offset"] + 512
        if payload == "int8":
            assert torch.equal(got["codes"], whole.r_anc.codes[:, lo:hi])
            assert torch.equal(got["scales"], whole.r_anc.scales[lo // 16:hi // 16])
        else:
            assert torch.equal(got["codes"], whole.r_anc[:, lo:hi])
    assert offsets == {0, 512}


@pytest.mark.parametrize("name", list(SAVED))
def test_load_with_a_mesh_reads_exactly_this_ranks_columns(world, name):
    payload, tile, cap = SAVED[name]
    step = world["out"] / f"saved_{name}" / "step_0"
    for rank, res in enumerate(world["ranks"]):
        got = res["index"][f"load/{name}"]
        assert got["equals_load_then_shard"], rank
        assert got["bytes_read"] < 0.6 * got["full_bytes"], (got["bytes_read"], got["full_bytes"])
        lo = got["offset"]
        hi = min(lo + got["local"], cap)
        ids = np.load(step / "item_ids.npy")
        np.testing.assert_array_equal(got["item_ids"][:hi - lo].numpy(), ids[lo:hi])
        if tile is None:
            np.testing.assert_array_equal(got["codes"][:, :hi - lo].numpy(),
                                          np.load(step / "r_anc.npy")[:, lo:hi])
        elif got["capacity"] == cap:
            np.testing.assert_array_equal(got["codes"].numpy(),
                                          np.load(step / "r_codes.npy")[:, lo:hi])
            np.testing.assert_array_equal(got["scales"].numpy(),
                                          np.load(step / "r_scales.npy")[lo // tile:hi // tile])
        else:   # re-padded to whole slabs: the tiles wholly inside the valid prefix keep
            keep = max(0, min(1000 - lo, hi - lo)) // tile * tile     # their bytes
            codes = np.load(step / "r_codes.npy")
            np.testing.assert_array_equal(got["codes"][:, :keep // 2].numpy(),
                                          codes[:, lo // 2:(lo + keep) // 2])


@pytest.mark.parametrize("payload", MUTATIONS)
def test_sharded_mutation_equals_unsharded_mutation_then_shard(world, payload):
    for rank, res in enumerate(world["ranks"]):
        got = res["index"][f"mutation/{payload}"]
        assert got["same"] and got["same_grown"], (rank, got)
        assert got["n_valid"] == 1000 - 10 + 6 - 3 and got["axes"] == ("items",)
        search = res["index"][f"mutated_search/{payload}"]
        assert search["sharded"] and search["same_ids"] and search["same_scores"], (rank, search)
        assert search["same_external"], rank


def test_sharded_quantize_realigns_slabs_to_whole_tiles(world):
    for res in world["ranks"]:
        got = res["index"]["quantize_realigns"]
        assert got["capacity"] == 1536 and got["local"] == 768 and got["same"]


def test_mesh_of_another_size_than_the_world_is_refused(world):
    for res in world["ranks"]:
        assert "needs 2 ranks, but the world has 4" in res["mesh_error"]


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "worker":
    sys.path.insert(0, str(ROOT / "src"))
    worker(sys.argv[2])
