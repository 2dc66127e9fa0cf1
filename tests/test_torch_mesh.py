"""The port's mesh paths over one gloo world of 4 CPU ranks, spawned once
for the module, held against the JAX package run live on the same numpy
inputs (its mesh checks are ``tests/test_multidevice.py``'s):

- the sequence-parallel decode core (``make_decode_core``) against
  ``transformer._local_decode_core`` at ``check_decode_attention``'s
  shapes: batch on ``data`` with the sequence on ``model``, and the
  ``long_500k`` layout (the sequence over both);
- the expert-parallel MoE (``make_moe_fn``) against ``moe_apply_local``,
  ``aux`` against the mean of the data shards' auxes (``check_moe_ep``),
  with and without ``scatter_tokens`` and shared experts;
- ``pipeline_forward`` against the plain tanh stage chain of
  ``check_pipeline``, at 2 and 4 stages;
- the int8 cross-pod reduce on a (pod 2, data 2, model 1) mesh: 10 steps
  within ``check_cross_pod_reduce``'s 5% accumulated error, each step's
  codes bit-equal to a single-process emulation of the reference's body;
- the mesh ``decode_step`` of two MoE LMs at ``smoke_config`` (2 x 2)
  against the single-device port, and that against the reference's;
- the sharded ``AnchorIndex.save`` (2 x 2): files byte for byte the
  unsharded save's, read by both packages' ``load``, and ``load(path,
  mesh)`` giving each rank its columns;
- the ``Router`` over two sharded replicas of 1 x 2
  (``make_replica_meshes``, ``RemoteReplica`` / ``serve_remote``): a scorer
  fault in one replica (also with the faulty rank holding its groups
  open, so that only their timeout releases its follower), a straggler, a
  swap mid-flight, a close with tickets in flight, and both replicas idle
  past their control groups' timeout (the leaders' keep-alives hold the
  followers); every request ends once, the healthy replica serves on, and
  every ``ok`` answer is bitwise the single-device engine's.

Each rank runs every case (this file, run as ``python
tests/test_torch_mesh.py worker DIR``) and saves its results; the tests
hold them.  ``compression`` runs in-process against the reference's.
"""

import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SPAWN_TIMEOUT = 240
TOL = 2e-4                                   # the reference's multidevice TOL

DEC = dict(b=4, s=64, kv=2, h=4, hd=16, pos=37)
MOE_D, MOE_T = 12, 32
MOE_CASES = {"plain": (0, False), "scatter": (0, True), "shared": (1, False),
             "shared+scatter": (1, True)}
PIPE_D, PIPE_B, PIPE_M = 6, 8, 4
XPOD_STEPS = 10
LM_ARCHS = ("granite-moe-1b-a400m", "moonshot-v1-16b-a3b")
LM_B, LM_STEPS = 4, 6
# saved sharded over (data 2, items 2): (payload, tile, capacity), n_valid 1000
SAVES = {"float32": ("float32", None, 1024), "bfloat16": ("bfloat16", None, 1024),
         "int8": ("int8", 128, 1024), "fp8": ("fp8", 128, 1024),
         "int4-unaligned": ("int4", 128, 1000)}
SAVE_KQ, SAVE_N, SAVE_TOKENS = 24, 1000, 6
# the router over two 1 x 2 replicas: a tabulated domain of 16 anchor rows
ROUTER_N, ROUTER_KQ, ROUTER_Q = 512, 16, 40
ROUTER_CFG = dict(k_anchor=12, n_rounds=4, budget_ce=24, k_retrieve=10, loop_mode="fori")
ROUTER_BUCKETS = (4, 8)
ROUTER_REQUESTS = 32
# the straggler's stall a batch, and the watchdog's threshold: the fleet
# median drifts to the healthy replica's own CPU batches (30-60 ms alone),
# so the threshold leaves a loaded CPU's batches 8x that, and the stall is
# still over 15x them
STALL_S, STRAGGLER_THRESHOLD = 1.0, 8.0
# the straggler's first requests arrive back to back: the router sends a
# request to the replica with the shorter queue (replica 0 on a tie), so the
# straggler gets one only while replica 0 has one queued, and spaced
# arrivals that replica 0 keeps up with would never reach it; within a
# burst of three replica 0 holds one (its batch outlasts three submits)
STRAGGLER_BURST = 3
SWAP_OFFSET = 10_000
# "fault_held": the fault, with the faulty rank holding its groups open;
# "idle": both replicas idle past their control groups' timeout mid-traffic
SCENARIOS = ("fault", "fault_held", "straggler", "swap", "close", "idle")
GROUP_TIMEOUT_S = 8.0                        # each replica's batch groups time out
IDLE_CONTROL_S = 3.0                         # "idle": the control groups and links time out
IDLE_S = 2 * IDLE_CONTROL_S                  # "idle": the pause between two halves of traffic


def _moe_cfg(n_shared):
    from repro_torch.configs.base import MoEConfig

    return MoEConfig(n_experts=8, top_k=2, d_expert=16, n_shared_experts=n_shared)


def _qids(n, seed):
    return np.random.default_rng(seed).integers(ROUTER_KQ, ROUTER_Q, n).tolist()


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------


def _decode_case(d, res):
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.decode_attention import make_decode_core
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    rank = dist.get_rank()
    di, mi = divmod(rank, 2)
    for name, batch_axes, seq_axes in (("data/model", ("data",), ("model",)),
                                       ("long_500k", (), ("data", "model"))):
        core = make_decode_core(mesh, batch_axes, seq_axes, DEC["s"], device="cpu")
        rows = slice(di * 2, di * 2 + 2) if batch_axes else slice(None)
        lo = core.offset
        ck = torch.tensor(d["ck"][rows, lo:lo + core.local_len])
        cv = torch.tensor(d["cv"][rows, lo:lo + core.local_len])
        o = core(torch.tensor(d["q"][rows]), torch.tensor(d["k_new"][rows]),
                 torch.tensor(d["v_new"][rows]), ck, cv, torch.tensor(DEC["pos"]))
        res[name] = dict(o=o, ck=ck, cv=cv, rows=rows, lo=lo)


def _moe_case(d, res):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    di = dist.get_rank() // 2
    x = torch.tensor(d["x"][di * 16:(di + 1) * 16])
    for name, (n_shared, scatter) in MOE_CASES.items():
        params = {k[len(name) + 1:]: torch.tensor(v) for k, v in d.items()
                  if k.startswith(name + "/")}
        if "shared/wg" in params:
            params["shared"] = {k: params.pop(f"shared/{k}") for k in ("wg", "wu", "wd")}
        fn = moe.make_moe_fn(mesh, _moe_cfg(n_shared), ("data",), "model", capacity_factor=8.0,
                             scatter_tokens=scatter, device="cpu")
        y, aux = fn(moe.expert_slice(params, mesh), x)
        res[name] = dict(y=y, aux=float(aux))


def _pipe_case(d, res):
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.pipeline import pipeline_forward, split_stages
    from repro_torch.launch.mesh import make_mesh

    rank = dist.get_rank()
    x = torch.tensor(d["x"])
    for n_stages, mesh in ((2, make_mesh((2, 2), ("data", "model"), device="cpu")),
                           (4, make_mesh((4,), ("stage",), device="cpu"))):
        axis = mesh.mesh_dim_names[0]
        ws = split_stages([torch.tensor(w) for w in d[f"w{n_stages}"]], n_stages)
        mine = ws[dist.get_rank(mesh.get_group(axis))]
        # the schedule: a tick ends with one shift, so a stage call's tick is
        # the number of shifts before it
        shifts, ran_at = [0], []
        shift = dist.all_to_all_single

        def counted_shift(*a, **kw):
            shifts[0] += 1
            return shift(*a, **kw)

        def stage_fn(ws_, h):
            ran_at.append(shifts[0])
            return _tanh_chain(ws_, h)

        piped = pipeline_forward(mesh, stage_fn, axis, PIPE_M, device="cpu")
        dist.all_to_all_single = counted_shift
        try:
            out = piped(mine, x)
        finally:
            dist.all_to_all_single = shift
        res[n_stages] = dict(out=out, ran=[t in ran_at for t in range(shifts[0])], rank=rank)


def _tanh_chain(ws, h):
    import torch

    for w in ws:
        h = torch.tanh(h @ w)
    return h


def _xpod_case(d, res):
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.compression import init_error_feedback
    from repro_torch.distributed.cross_pod import make_hierarchical_grad_reduce
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    rank = dist.get_rank()
    pod, di = divmod(rank, 2)
    # "w" split over (data, model) as in check_cross_pod_reduce; "b" whole on
    # every rank, each data rank with its own gradient (the pod's mean first)
    grads = {"w": torch.tensor(d["g"][pod, di * 4:(di + 1) * 4]),
             "b": torch.tensor(d["gb"][pod, di])}
    reduce_fn = make_hierarchical_grad_reduce(mesh, {"w": ("data", "model")}, device="cpu")
    err = init_error_feedback(grads)
    steps, codes = [], []
    for _ in range(XPOD_STEPS):
        out, err = reduce_fn(grads, err)
        steps.append(out)
        codes.append({k: q for k, (q, _) in reduce_fn.last_payload.items()})
    flat = make_hierarchical_grad_reduce(make_mesh((2, 2), ("data", "model"), device="cpu"),
                                         device="cpu")
    same = flat(grads, err)
    res.update(steps=steps, codes=codes, identity=same[0] is grads and same[1] is err)


def _lm_case(d, res):
    import torch
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.configs.base import LMShape
    from repro_torch.distributed.decode_attention import make_decode_core
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe, transformer

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    di = dist.get_rank() // 2
    rows = slice(di * LM_B // 2, (di + 1) * LM_B // 2)
    for arch in LM_ARCHS:
        cfg = registry.smoke_config(arch)
        params = d[arch]["params"]
        core = make_decode_core(mesh, ("data",), ("model",), LM_STEPS, device="cpu")
        moe_fn = moe.make_moe_fn(mesh, cfg.moe, ("data",), device="cpu")
        mine = dict(params)
        for part in ("prefix", "layers"):
            mine[part] = [dict(lp, moe=moe.expert_slice(lp["moe"], mesh)) if "moe" in lp else lp
                          for lp in params.get(part, [])]
        cache = transformer.init_cache(cfg, LM_B // 2, core.local_len, device="cpu")
        tokens = torch.tensor(d[arch]["tokens"][rows])
        logits = [transformer.decode_step(mine, cache, tokens[:, t], torch.tensor(t), cfg,
                                          moe_fn=moe_fn, decode_core=core)[0]
                  for t in range(LM_STEPS)]
        bundle = steps.build_lm_decode(arch, cfg, LMShape("mesh", "decode", 8, LM_B),
                                       params=params, device="cpu", mesh=mesh)
        res[arch] = dict(logits=logits, rows=rows,
                         built=bundle.step(*bundle.args)[0], built_rows=rows)


def _save_index(name, d):
    import torch

    from repro_torch.core.index import AnchorIndex

    payload, tile, cap = SAVES[name]
    idx = AnchorIndex.from_r_anc(torch.tensor(d["r"]), capacity=cap)
    if name == "float32":
        idx = idx.with_latents(anchor_pos=torch.arange(0, 800, 100)).with_item_tokens(
            torch.tensor(d["tokens"]))
    if payload == "bfloat16":
        idx = idx.quantize("bfloat16")
    elif tile is not None:
        idx = idx.quantize(payload, tile=tile)
    return idx


def _save_case(d, out, res):
    import torch.distributed as dist

    from repro_torch.core.index import AnchorIndex
    from repro_torch.launch.mesh import make_serving_mesh

    mesh = make_serving_mesh(2, 2, device="cpu")
    for name in SAVES:
        sharded = _save_index(name, d).shard(mesh)
        path = str(out / f"saved_{name}")
        t0 = time.perf_counter()
        sharded.save(path)
        back = AnchorIndex.load(path, mesh=mesh)
        res[name] = dict(seconds=time.perf_counter() - t0,
                         same=_same_slab(back, sharded), offset=sharded.item_offset,
                         rank=dist.get_rank(), capacity=sharded.capacity)
    # a rank that fails its write leaves no committed save, and every rank raises
    sharded = _save_index("int8", d).shard(mesh)
    path = out / "saved_failing"
    os.makedirs(path, exist_ok=True)
    if dist.get_rank() == 1:        # a piece writer (data 0, items 1): its write overflows
        sharded = dataclass_replace(sharded, item_ids=sharded.item_ids.repeat(2))
    try:
        sharded.save(str(path))
        res["failing"] = "saved"
    except RuntimeError as e:
        res["failing"] = str(e)
    res["failing_left"] = sorted(os.listdir(path))


def _same_slab(a, b) -> bool:
    import torch

    from repro_torch.kernels.approx_topk.quant import QuantizedRanc

    def parts(x):
        r = x.r_anc
        pay = [r.codes, r.scales] if isinstance(r, QuantizedRanc) else [r]
        return pay + [x.item_ids, x.n_valid, x.anchor_query_ids] + [
            t for t in (x.item_embeddings, x.item_tokens, x.u, x.anchor_item_pos)
            if t is not None]

    def raw(t):
        return t.reshape(-1).contiguous().view(torch.uint8)

    pa, pb = parts(a), parts(b)
    return len(pa) == len(pb) and all(
        u.dtype == v.dtype and u.shape == v.shape and torch.equal(raw(u), raw(v))
        for u, v in zip(pa, pb))


def _router_case(d, scenario, res):
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core.engine import AdaCURRetriever
    from repro_torch.core.index import AnchorIndex
    from repro_torch.launch.faults import (FaultPlan, FaultyScorer, ScorerFault, SleepFault,
                                           SwapFault)
    from repro_torch.launch.mesh import make_replica_meshes
    from repro_torch.launch.router import RemoteReplica, Router, serve_remote
    from repro_torch.launch.serve import AdaCURService

    rank = dist.get_rank()
    NamespaceScorer = _namespace_scorer()
    idle = scenario == "idle"
    rm = make_replica_meshes(2, 1, 2, device="cpu", timeout_s=GROUP_TIMEOUT_S,
                             control_timeout_s=IDLE_CONTROL_S if idle else None)
    m = torch.tensor(d["m"])
    base = AnchorIndex.from_r_anc(m[:ROUTER_KQ])
    index = base.shard(rm.mesh)
    plan = None
    if scenario.startswith("fault") and rank == 2:
        # replica 1's leader, its item shard 0, which calls the scorer for the
        # replica: its second call (the first batch's round 1) raises
        plan = FaultPlan([ScorerFault(call_k=2)])

    svc = AdaCURService(retriever=AdaCURRetriever.from_index(
        index, FaultyScorer(NamespaceScorer(m), plan), AdaCURConfig(**ROUTER_CFG)),
        max_batch=ROUTER_BUCKETS[-1], batch_buckets=list(ROUTER_BUCKETS), max_wait_s=60.0,
        deterministic=True, group=rm.group, control=rm.control)
    held, destroy = [], dist.destroy_process_group
    if scenario == "fault_held" and rank == 2:
        # the faulty rank's teardown closes nothing: a stray reference holds
        # each of its replica's groups, and ending a group does nothing
        held = [svc._group, svc._control, *rm.mesh.get_all_groups()]
        dist.destroy_process_group = lambda *a, **kw: None
    if scenario == "swap":
        # every rank stages its slab of the relabelled index, before any batch
        svc.stage_index(dataclass_replace(index, item_ids=torch.where(
            index.item_ids >= 0, index.item_ids + SWAP_OFFSET, index.item_ids)))
    del index
    out = dict(scenario=scenario, rank=rank, replica=rm.replica)
    t0 = time.monotonic()
    if rank == 0:
        remote = RemoteReplica(rm.links[1], 2, ROUTER_BUCKETS[-1])
        router_plan = None
        kw = {}
        if scenario == "straggler":
            router_plan = FaultPlan(sleep_faults=[SleepFault(replica=1, seconds=STALL_S)])
            kw = dict(watchdog_threshold=STRAGGLER_THRESHOLD, watchdog_patience=1,
                      hedge_after_s=STALL_S / 3)
        if scenario == "swap":
            router_plan = FaultPlan(swap_faults=[SwapFault(at_seq=ROUTER_REQUESTS // 2)])
            kw = dict(swap_index_fn=lambda: None)
        if scenario.startswith("fault"):
            kw = dict(max_consecutive_errors=1)
        router = Router([svc, remote], queue_limit=256, plan=router_plan, **kw)
        if scenario == "straggler":   # the fleet baseline: healthy CPU batches
            router.replicas[0].watchdog.window.extend([STALL_S / 10] * 20)
            out["watch"] = _record_watchdogs(router)
        qids = _qids(ROUTER_REQUESTS, seed=SCENARIOS.index(scenario))
        tickets, submit_t = [], []
        for i, q in enumerate(qids):
            if idle and i == len(qids) // 2:
                for t in tickets:       # the first half answered, then no traffic
                    router.result(t, timeout=60.0)
                out["idle_s"] = time.monotonic()
                time.sleep(IDLE_S)
                out["idle_s"] = time.monotonic() - out["idle_s"]
            tickets.append(router.submit(q))
            submit_t.append(time.monotonic() - t0)
            if scenario == "straggler" and i >= STRAGGLER_BURST - 1:
                time.sleep(0.02)
            if scenario == "swap" and i == 0:
                # one answer from the old index: back-to-back submits can
                # reach the swap before a replica thread starts a batch
                router.result(tickets[0], timeout=60.0)
        if scenario != "close":
            for t in tickets:
                router.result(t, timeout=60.0)
        router.close()
        outs = [t.outcome for t in tickets]
        out.update(qids=qids, seqs=[t.seq for t in tickets],
                   outcomes=[None if o is None else dict(
                       seq=o.seq, query_id=o.query_id, status=o.status, replica=o.replica,
                       attempts=o.attempts, hedged=o.hedged, retried=o.retried,
                       error=None if o.response is None else o.response.error,
                       item_ids=None if o.response is None or o.response.item_ids is None
                       else np.asarray(o.response.item_ids),
                       scores=None if o.response is None or o.response.scores is None
                       else np.asarray(o.response.scores),
                       batch=None if o.response is None else (o.response.batch_id,
                                                              o.response.batch_row))
                       for o in outs],
                   stats=dict(router.stats), quarantined=list(router.quarantined),
                   submit_t=submit_t, tried=[list(t.replicas_tried) for t in tickets],
                   log=svc.batch_log, link_keepalives=remote.keepalives)
    elif rank == rm.leader:
        try:
            out["served"] = serve_remote(svc, rm.links[1])
        except Exception as e:  # noqa: BLE001 — the raise is the result
            out["raised"] = f"{type(e).__name__}: {e}"
        out["log"] = svc.batch_log
    else:
        try:
            out["batches"] = svc.follow()
        except Exception as e:  # noqa: BLE001 — the raise is the result
            out["raised"] = f"{type(e).__name__}: {e}"
    out.update(seconds=time.monotonic() - t0, mesh_error=svc.mesh_error,
               world_alive=dist.is_initialized(), keepalives=svc.keepalives)
    res[scenario] = out
    dist.destroy_process_group = destroy
    del held
    dist.barrier()                                     # the world outlives every replica


def _record_watchdogs(router) -> list:
    """Every watchdog observation of ``router``'s replicas, in order:
    {replica, step, seconds, median, threshold, straggler, t}, the median
    and threshold as they stood before the observation."""
    rec, t0 = [], time.monotonic()
    for rep in router.replicas:
        wd = rep.watchdog

        def observe(step, seconds, wd=wd, rid=rep.rid, orig=rep.watchdog.observe):
            med = wd._median()
            st = orig(step, seconds)
            rec.append(dict(replica=rid, step=step, seconds=seconds, median=med,
                            threshold=wd.threshold * med, straggler=st.straggler,
                            t=time.monotonic() - t0))
            return st

        wd.observe = observe
    return rec


def _namespace_scorer():
    from repro_torch.core.scorer import TabulatedScorer

    class NamespaceScorer(TabulatedScorer):
        """Answers both id namespaces of the swap (ids + SWAP_OFFSET)."""

        def __call__(self, query, item_idx):
            return super().__call__(query, item_idx % SWAP_OFFSET)

    return NamespaceScorer


def dataclass_replace(obj, **kw):
    import dataclasses

    return dataclasses.replace(obj, **kw)


def worker(out_dir: str) -> None:
    import faulthandler

    import torch
    import torch.distributed as dist

    # a rank still running near the world's timeout prints every thread's
    # stack and exits, so a hang names where it waits
    faulthandler.dump_traceback_later(SPAWN_TIMEOUT - 30, exit=True)
    torch.set_num_threads(1)
    out = Path(out_dir)
    dist.init_process_group("gloo")
    rank = dist.get_rank()
    res = {"seconds": {}}
    cases = [("decode", lambda r: _decode_case(np.load(out / "decode.npz"), r)),
             ("moe", lambda r: _moe_case(dict(np.load(out / "moe.npz")), r)),
             ("pipe", lambda r: _pipe_case(dict(np.load(out / "pipe.npz")), r)),
             ("xpod", lambda r: _xpod_case(np.load(out / "xpod.npz"), r)),
             ("lm", lambda r: _lm_case(torch.load(out / "lm.pt", weights_only=False), r)),
             ("save", lambda r: _save_case(np.load(out / "save.npz"), out, r))]
    cases += [(f"router:{s}", lambda r, s=s: _router_case(np.load(out / "router.npz"), s, r))
              for s in SCENARIOS]
    for name, fn in cases:
        t0 = time.monotonic()
        key = name.split(":")[0]
        fn(res.setdefault(key, {}))
        res["seconds"][name] = time.monotonic() - t0
        print(f"rank {rank}: {name} done in {res['seconds'][name]:.2f} s", file=sys.stderr,
              flush=True)
    torch.save(res, out / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------

if __name__ != "__main__":
    torch = pytest.importorskip("torch")
    torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp  # noqa: E402


def _inputs(out):
    """Every case's numpy inputs, from seeds, written for the ranks."""
    from repro_torch.configs import registry
    from repro_torch.models import moe

    rng = np.random.default_rng(0)
    b, s, kv, h, hd = (DEC[k] for k in ("b", "s", "kv", "h", "hd"))
    dec = dict(q=rng.standard_normal((b, h, hd)), k_new=rng.standard_normal((b, kv, hd)),
               v_new=rng.standard_normal((b, kv, hd)), ck=rng.standard_normal((b, s, kv, hd)),
               cv=rng.standard_normal((b, s, kv, hd)))
    dec = {k: v.astype(np.float32) for k, v in dec.items()}
    moe_in = {"x": rng.standard_normal((MOE_T, MOE_D)).astype(np.float32)}
    for name, (n_shared, _) in MOE_CASES.items():
        p = moe.moe_init(torch.Generator().manual_seed(1 + n_shared), MOE_D, _moe_cfg(n_shared))
        for k, v in p.items():
            for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
                moe_in[f"{name}/{k}" + (f"/{kk}" if kk else "")] = vv.numpy()
    pipe = {"x": rng.standard_normal((PIPE_B, PIPE_D)).astype(np.float32)}
    for n in (2, 4):
        pipe[f"w{n}"] = (rng.standard_normal((n, PIPE_D, PIPE_D)) / np.sqrt(PIPE_D)).astype(
            np.float32)
    xpod = dict(g=rng.standard_normal((2, 8, 8)).astype(np.float32),
                gb=rng.standard_normal((2, 2, 5)).astype(np.float32))
    from _torch_lm import lm_params, ref_tree

    lm = {}
    for arch in LM_ARCHS:
        cfg = registry.smoke_config(arch)
        params = lm_params(cfg, seed=3)
        lm[arch] = dict(params=params, tree=ref_tree(params), tokens=rng.integers(
            0, cfg.vocab_size, (LM_B, LM_STEPS)).astype(np.int32))
    torch.save(lm, out / "lm.pt")
    save = dict(r=rng.standard_normal((SAVE_KQ, SAVE_N)).astype(np.float32),
                tokens=rng.integers(1, 50, (SAVE_N, SAVE_TOKENS)).astype(np.int32))
    router = dict(m=rng.standard_normal((ROUTER_Q, ROUTER_N)).astype(np.float32))
    for name, arrs in (("decode", dec), ("moe", moe_in), ("pipe", pipe), ("xpod", xpod),
                       ("save", save), ("router", router)):
        np.savez(out / f"{name}.npz", **arrs)
    return dict(decode=dec, moe=moe_in, pipe=pipe, xpod=xpod, lm=lm, save=save, router=router)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from repro_torch.testing import run_world

    out = tmp_path_factory.mktemp("mesh")
    inputs = _inputs(out)
    t0 = time.monotonic()
    ranks = run_world([sys.executable, __file__, "worker", str(out)], WORLD, SPAWN_TIMEOUT,
                      env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    spawn_s = time.monotonic() - t0
    for r, (rc, o, e) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}\n{o}\n{e[-6000:]}"
    return dict(out=out, inputs=inputs, spawn_s=spawn_s,
                ranks=[torch.load(out / f"rank{r}.pt", weights_only=False)
                       for r in range(WORLD)])


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


# -- compression (in-process) ---------------------------------------------------


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.standard_normal((16, 24)), "b": rng.standard_normal(24),
            "layers": [{"k": rng.standard_normal((4, 8)) * 1e-3}, {"k": np.zeros((4, 8))}]}
    tree["layers"][1]["k"][1, 2] = 5.0
    # exact ties at the top-k threshold: equal magnitudes of both signs
    tree["ties"] = np.repeat([0.5, -0.5, 0.25], 12)
    return _tree_map(lambda x: np.asarray(x, np.float32), tree)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _pairs(a, b):
    if isinstance(a, dict):
        return [p for k in a for p in _pairs(a[k], b[k])]
    if isinstance(a, list):
        return [p for x, y in zip(a, b) for p in _pairs(x, y)]
    return [(a, b)]


def test_int8_quantize_codes_are_the_references_bits():
    from repro.distributed import compression as j_comp
    from repro_torch.distributed import compression

    for leaf in _pairs(_grad_tree(0), _grad_tree(0)):
        g = leaf[0]
        q, s = compression.int8_quantize(torch.tensor(g))
        jq, js = j_comp.int8_quantize(jnp.asarray(g))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(s), float(js), rtol=1e-7)
        np.testing.assert_allclose(compression.int8_dequantize(q, s).numpy(),
                                   np.asarray(j_comp.int8_dequantize(jq, js)), rtol=1e-6,
                                   atol=1e-12)


@pytest.mark.parametrize("fn", ["int8_roundtrip_with_feedback", "topk_sparsify_with_feedback"])
def test_feedback_compressors_match_the_reference_over_steps(fn):
    """Five steps of error feedback on a tree: each step's output and
    residual against the reference's (the top-k kept sets equal, ties at
    the threshold included)."""
    from repro.distributed import compression as j_comp
    from repro_torch.distributed import compression

    grads = _grad_tree(1)
    err = compression.init_error_feedback(_tree_map(torch.tensor, grads))
    jerr = j_comp.init_error_feedback(_tree_map(jnp.asarray, grads))
    kw = {"frac": 0.1} if fn.startswith("topk") else {}
    for step in range(5):
        g = _tree_map(lambda x: x * (1.0 + 0.1 * step), grads)
        out, err = getattr(compression, fn)(_tree_map(torch.tensor, g), err, **kw)
        jout, jerr = getattr(j_comp, fn)(_tree_map(jnp.asarray, g), jerr, **kw)
        for (a, b) in _pairs(out, jout) + _pairs(err, jerr):
            a, b = a.numpy(), np.asarray(b)
            if fn.startswith("topk"):
                np.testing.assert_array_equal(a != 0, b != 0, err_msg=f"step {step}")
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=f"step {step}")


def test_topk_threshold_is_lax_top_k_s():
    from repro_torch.distributed.compression import topk_threshold
    from repro_torch.kernels.approx_topk.select import stable_topk

    g = _grad_tree(2)["ties"]
    for frac in (0.05, 0.3, 0.5, 0.7):
        k = max(1, int(g.size * frac))
        want = float(jax.lax.top_k(jnp.abs(jnp.asarray(g)), k)[0][-1])
        assert float(topk_threshold(torch.tensor(g), frac)) == want
        _, ids = jax.lax.top_k(jnp.abs(jnp.asarray(g)), k)
        np.testing.assert_array_equal(stable_topk(torch.tensor(np.abs(g))[None], k)[1][0].numpy(),
                                      np.asarray(ids))


def test_init_error_feedback_is_fp32_zeros_like_the_tree():
    from repro_torch.distributed.compression import init_error_feedback

    tree = {"a": torch.ones(3, dtype=torch.bfloat16), "b": [torch.ones(2, 2)]}
    err = init_error_feedback(tree)
    assert err["a"].dtype == torch.float32 and err["a"].shape == (3,)
    assert not err["b"][0].any()


# -- the decode core -----------------------------------------------------------


@pytest.mark.parametrize("layout", ["data/model", "long_500k"])
def test_sp_decode_core_matches_the_reference_local_core(world, layout):
    from repro.models import transformer as j_tf

    d = world["inputs"]["decode"]
    ref_o, ref_ck, ref_cv = jax.jit(j_tf._local_decode_core)(
        *(jnp.asarray(d[k]) for k in ("q", "k_new", "v_new", "ck", "cv")),
        jnp.int32(DEC["pos"]))
    for r in world["ranks"]:
        got = r["decode"][layout]
        rows, lo = got["rows"], got["lo"]
        n = got["ck"].shape[1]
        _close(got["o"], np.asarray(ref_o)[rows], f"o rank {r}")
        _close(got["ck"], np.asarray(ref_ck)[rows, lo:lo + n], "ck")
        _close(got["cv"], np.asarray(ref_cv)[rows, lo:lo + n], "cv")
        assert np.isfinite(got["o"].numpy()).all()


def test_sp_decode_core_writes_only_the_owning_chunk(world):
    d = world["inputs"]["decode"]
    for r in world["ranks"]:
        got = r["decode"]["long_500k"]
        lo, n = got["lo"], got["ck"].shape[1]
        changed = np.nonzero((got["ck"].numpy() != d["ck"][:, lo:lo + n]).any(axis=(0, 2, 3)))[0]
        owns = lo <= DEC["pos"] < lo + n
        assert changed.tolist() == ([DEC["pos"] - lo] if owns else [])


# -- expert parallelism --------------------------------------------------------


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_ep_moe_matches_moe_apply_local(world, case):
    from repro.models import moe as j_moe

    n_shared, scatter = MOE_CASES[case]
    d = world["inputs"]["moe"]
    params = {}
    for k, v in d.items():
        if k.startswith(case + "/"):
            parts = k.split("/")[1:]
            (params.setdefault(parts[0], {}).__setitem__(parts[1], jnp.asarray(v))
             if len(parts) == 2 else params.__setitem__(parts[0], jnp.asarray(v)))
    from repro.configs.base import MoEConfig

    jcfg = MoEConfig(n_experts=8, top_k=2, d_expert=16, n_shared_experts=n_shared)
    x = jnp.asarray(d["x"])
    run = jax.jit(lambda p, xx: j_moe.moe_apply_local(p, xx, jcfg, capacity_factor=8.0))
    y_ref = np.asarray(run(params, x)[0])
    aux_ref = np.mean([float(run(params, xs)[1]) for xs in jnp.split(x, 2)])
    for rank, r in enumerate(world["ranks"]):
        di, mi = divmod(rank, 2)
        rows = (slice(di * 16 + mi * 8, di * 16 + mi * 8 + 8) if scatter
                else slice(di * 16, di * 16 + 16))
        _close(r["moe"][case]["y"], y_ref[rows], f"{case} rank {rank}")
        np.testing.assert_allclose(r["moe"][case]["aux"], aux_ref, rtol=1e-4)


# -- the pipeline ----------------------------------------------------------------


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipeline_matches_the_plain_stage_chain(world, n_stages):
    d = world["inputs"]["pipe"]
    ref = jnp.asarray(d["x"])
    for w in d[f"w{n_stages}"]:
        ref = jnp.tanh(ref @ jnp.asarray(w))
    for r in world["ranks"]:
        _close(r["pipe"][n_stages]["out"], np.asarray(ref), f"{n_stages} stages")


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipeline_runs_the_gpipe_schedule(world, n_stages):
    """S + M - 1 ticks; stage s runs exactly ticks s .. s + M - 1."""
    for rank, r in enumerate(world["ranks"]):
        ran = r["pipe"][n_stages]["ran"]
        s = rank // 2 if n_stages == 2 else rank
        assert len(ran) == n_stages + PIPE_M - 1
        assert [t for t, x in enumerate(ran) if x] == list(range(s, s + PIPE_M))


# -- the cross-pod reduce ----------------------------------------------------------


def _xpod_emulation(d):
    """The reference's body (``cross_pod.make_hierarchical_grad_reduce``'s
    ``one``) in one process with jnp: per data shard of "w", per data rank
    of "b" after the pod's mean; the shared scale a max over both pods."""
    g = jnp.asarray(d["g"])
    gb = jnp.asarray(d["gb"]).mean(axis=1)                    # the pods' data means
    leaves = {"w": [g[:, i * 4:(i + 1) * 4] for i in range(2)], "b": [gb, gb]}
    errs = {k: [jnp.zeros_like(gp) for gp in per_shard] for k, per_shard in leaves.items()}
    out = []
    for _ in range(XPOD_STEPS):
        step = {}
        for k, per_shard in leaves.items():
            step[k] = []
            for i, gp in enumerate(per_shard):
                g32 = gp.astype(jnp.float32) + errs[k][i]
                scale = jnp.max(jnp.abs(g32)) / 127.0 + 1e-12
                q = jnp.clip(jnp.round(g32 / scale), -127, 127).astype(jnp.int8)
                deq = q.astype(jnp.int32).sum(0).astype(jnp.float32) * scale / 2
                errs[k][i] = g32 - q.astype(jnp.float32) * scale
                step[k].append((np.asarray(deq), np.asarray(q)))
        out.append(step)
    return out


def test_cross_pod_reduce_converges_and_is_the_reference_body(world):
    d = world["inputs"]["xpod"]
    emu = _xpod_emulation(d)
    true_w = (d["g"][0] + d["g"][1]) / 2
    for rank, r in enumerate(world["ranks"]):
        pod, di = divmod(rank, 2)
        total = np.zeros((4, 8))
        for t, out in enumerate(r["xpod"]["steps"]):
            w = out["w"].numpy()
            np.testing.assert_array_equal(w, emu[t]["w"][di][0], err_msg=f"step {t}")
            np.testing.assert_array_equal(out["b"].numpy(), emu[t]["b"][di][0])
            total += w
        want = XPOD_STEPS * true_w[di * 4:(di + 1) * 4]
        assert np.abs(total - want).max() / np.abs(want).max() < 0.05
        assert r["xpod"]["identity"]


def test_cross_pod_codes_are_bit_equal_to_the_emulation(world):
    """The int8 payload itself, step by step, on every rank."""
    emu = _xpod_emulation(world["inputs"]["xpod"])
    for rank, r in enumerate(world["ranks"]):
        pod, di = divmod(rank, 2)
        for t, codes in enumerate(r["xpod"]["codes"]):
            for k in ("w", "b"):
                assert codes[k].dtype == torch.int8
                np.testing.assert_array_equal(codes[k].numpy(), emu[t][k][di][1][pod],
                                              err_msg=f"{k} step {t}")


# -- the mesh decode step of a MoE LM ------------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_mesh_decode_step_matches_single_device_and_reference(world, arch):
    from repro.configs import registry as j_registry
    from repro.models import transformer as j_tf
    from repro_torch.configs import registry
    from repro_torch.configs.base import LMShape
    from repro_torch.launch import steps
    from repro_torch.models import transformer

    cfg, jcfg = registry.smoke_config(arch), j_registry.smoke_config(arch)
    tree, params = world["inputs"]["lm"][arch]["tree"], world["inputs"]["lm"][arch]["params"]
    tokens = world["inputs"]["lm"][arch]["tokens"]
    cache = transformer.init_cache(cfg, LM_B, LM_STEPS, device="cpu")
    single = [transformer.decode_step(params, cache, torch.tensor(tokens[:, t]), t, cfg)[0]
              for t in range(LM_STEPS)]
    dec = jax.jit(lambda p, c, tk, pos: j_tf.decode_step(p, c, tk, pos, jcfg))
    jparams = jax.tree.map(jnp.asarray, tree)
    jc = j_tf.init_cache(jcfg, LM_B, LM_STEPS)
    for t in range(LM_STEPS):
        lg, jc = dec(jparams, jc, jnp.asarray(tokens[:, t]), jnp.int32(t))
        _rel(single[t], np.asarray(lg), f"single vs reference, step {t}")
        for r in world["ranks"]:
            got = r["lm"][arch]
            _rel(got["logits"][t], single[t][got["rows"]], f"mesh vs single, step {t}")
    full = steps.build_lm_decode(arch, cfg, LMShape("mesh", "decode", 8, LM_B),
                                 params=params, device="cpu")
    want = full.step(*full.args)[0]
    for r in world["ranks"]:
        got = r["lm"][arch]
        _rel(got["built"], want[got["built_rows"]], "build_lm_decode(mesh=)")


def _rel(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    assert np.abs(got - want).max() <= TOL * max(np.abs(want).max(), 1.0), what


# -- the sharded save -------------------------------------------------------------


@pytest.mark.parametrize("name", list(SAVES))
def test_sharded_save_writes_the_unsharded_files(world, name, tmp_path):
    """Byte for byte: every leaf file, index_meta.json, and the manifest
    but for the item-axis leaves' recorded placement."""
    import json

    from repro.core.index import AnchorIndex as JIndex
    from repro_torch.core.index import AnchorIndex

    d = world["inputs"]["save"]
    idx = _save_index(name, d)
    cap = world["ranks"][0]["save"][name]["capacity"]
    if idx.capacity != cap:
        idx = idx.with_capacity(cap)                 # the index the shards hold
    plain = tmp_path / "plain"
    idx.save(str(plain))
    got = world["out"] / f"saved_{name}"
    step_a, step_b = plain / "step_0", got / "step_0"
    files = sorted(os.listdir(step_a))
    assert files == sorted(os.listdir(step_b))
    for f in files:
        if f != "manifest.json":
            assert (step_a / f).read_bytes() == (step_b / f).read_bytes(), f
    assert (plain / "index_meta.json").read_bytes() == (got / "index_meta.json").read_bytes()
    ma, mb = (json.loads((p / "manifest.json").read_text())["leaves"] for p in (step_a, step_b))
    placed = {"r_anc": [None, ["items"]], "r_codes": [None, ["items"]],
              "r_scales": [["items"]], "item_ids": [["items"]],
              "item_embeddings": [None, ["items"]], "item_tokens": [["items"], None]}
    assert ma.keys() == mb.keys()
    for k in ma:
        spec_a, spec_b = ma[k].pop("spec"), mb[k].pop("spec")
        assert ma[k] == mb[k], k
        assert spec_b == placed.get(k, spec_a), (k, spec_b)
    # both packages' unsharded loads read it, every leaf the index's own
    back = AnchorIndex.load(str(got), device="cpu")
    assert _same_slab(back, idx)
    ref = JIndex.load(str(got))
    assert ref.n_items == idx.n_items and ref.capacity == idx.capacity
    r_ref = ref.r_anc
    codes = np.asarray(r_ref.codes) if hasattr(r_ref, "codes") else np.asarray(r_ref)
    own = idx.r_anc.codes if hasattr(idx.r_anc, "codes") else idx.r_anc
    assert codes.tobytes() == own.contiguous().view(torch.uint8).numpy().tobytes()
    np.testing.assert_array_equal(np.asarray(ref.item_ids), idx.item_ids.numpy())


@pytest.mark.parametrize("name", list(SAVES))
def test_sharded_save_loads_back_onto_the_mesh(world, name):
    for r in world["ranks"]:
        assert r["save"][name]["same"], (name, r["save"][name]["rank"])


def test_a_failed_rank_write_commits_nothing_and_raises_everywhere(world):
    for r in world["ranks"]:
        assert "sharded save failed" in r["save"]["failing"], r["save"]["failing"]
        assert r["save"]["failing_left"] == [], r["save"]["failing_left"]


# -- the router over sharded replicas ------------------------------------------------


def _single_device_answers(world, log, swapped):
    """Every logged batch searched again by one device's engine: {(batch
    id, row): (item ids, scores)}."""
    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core import prng
    from repro_torch.core.engine import AdaCURRetriever
    from repro_torch.core.index import AnchorIndex
    from repro_torch.core.scorer import TabulatedScorer

    m = torch.tensor(world["inputs"]["router"]["m"])
    index = AnchorIndex.from_r_anc(m[:ROUTER_KQ])
    ret = AdaCURRetriever.from_index(index, TabulatedScorer(m), AdaCURConfig(**ROUTER_CFG))
    out = {}
    for bl in log:
        res = ret.search(torch.tensor(bl["query_ids"]), prng.PRNGKey(0))
        ids = index.gather_item_ids(res.topk_idx).numpy()
        for i in range(bl["rows"]):
            out[(bl["batch_id"], i)] = (ids[i], res.topk_scores[i].numpy())
    return out


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_router_over_sharded_replicas_ends_each_request_once(world, scenario):
    lead = world["ranks"][0]["router"][scenario]
    outs = lead["outcomes"]
    assert len(outs) == ROUTER_REQUESTS and all(o is not None for o in outs)
    assert [o["seq"] for o in outs] == lead["seqs"]
    assert [o["query_id"] for o in outs] == lead["qids"]
    st = lead["stats"]
    assert st["submitted"] == ROUTER_REQUESTS
    assert st["ok"] + st["errors"] + st["rejected"] == ROUTER_REQUESTS
    for r in world["ranks"]:
        assert r["router"][scenario]["world_alive"]        # no call destroyed the world
        assert r["router"][scenario]["seconds"] < 60


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_router_ok_answers_are_the_single_device_engines(world, scenario):
    lead = world["ranks"][0]["router"][scenario]
    logs = {0: lead["log"], 1: world["ranks"][2]["router"][scenario]["log"]}
    want = {rid: _single_device_answers(world, log, scenario == "swap")
            for rid, log in logs.items()}
    n_ok = 0
    for o in lead["outcomes"]:
        if o["status"] != "ok":
            continue
        ids, scores = want[o["replica"]][o["batch"]]
        got_ids = o["item_ids"]
        if scenario == "swap" and got_ids.min() >= SWAP_OFFSET:
            got_ids = got_ids - SWAP_OFFSET
        np.testing.assert_array_equal(got_ids, ids)
        np.testing.assert_array_equal(o["scores"], scores)
        n_ok += 1
    assert n_ok > 0 or scenario == "close"


def test_a_fault_in_one_replica_leaves_the_other_serving(world):
    ranks = [r["router"]["fault"] for r in world["ranks"]]
    lead = ranks[0]
    assert lead["quarantined"] == [1]
    assert all(o["status"] == "ok" for o in lead["outcomes"])   # retried on replica 0
    assert any(o["retried"] for o in lead["outcomes"])
    # replica 1 ended its own mesh: its leader answered errors and served on
    # over the link, its follower's next collective failed at once; replica
    # 0's ranks never saw a failure
    assert "FaultInjectedError" in ranks[2]["mesh_error"] and ranks[3]["mesh_error"]
    assert "raised" in ranks[3] and "raised" not in ranks[2]
    assert ranks[3]["seconds"] < GROUP_TIMEOUT_S        # released by the teardown
    assert ranks[0]["mesh_error"] is None and ranks[1]["mesh_error"] is None
    assert "raised" not in ranks[1]


def test_a_fault_whose_groups_are_held_open_is_bounded_by_their_timeout(world):
    """The faulty rank keeps a reference to each of its replica's batch
    groups, so ending them closes nothing: its follower is released by the
    groups' timeout, and the other replica serves on as before."""
    ranks = [r["router"]["fault_held"] for r in world["ranks"]]
    lead = ranks[0]
    assert lead["quarantined"] == [1]
    assert all(o["status"] == "ok" for o in lead["outcomes"])
    assert "FaultInjectedError" in ranks[2]["mesh_error"] and "raised" not in ranks[2]
    assert "raised" in ranks[3] and ranks[3]["mesh_error"]
    assert GROUP_TIMEOUT_S <= ranks[3]["seconds"] < GROUP_TIMEOUT_S + 30, ranks[3]["raised"]
    assert ranks[0]["mesh_error"] is None and ranks[1]["mesh_error"] is None
    assert "raised" not in ranks[1]


def test_a_straggler_replica_is_quarantined_and_hedged_around(world):
    lead = world["ranks"][0]["router"]["straggler"]
    for w in lead["watch"]:       # the watchdogs' record, shown when the test fails
        print("straggler watch", {k: round(v, 4) if isinstance(v, float) else v
                                  for k, v in w.items()})
    print("straggler outcomes", [(o["replica"], o["hedged"], o["attempts"])
                                 for o in lead["outcomes"]])
    print("straggler dispatches", [(round(t, 4), tried)
                                   for t, tried in zip(lead["submit_t"], lead["tried"])])
    assert lead["quarantined"] == [1], [round(bl["seconds"], 3) for bl in lead["log"]]
    assert all(o["status"] == "ok" for o in lead["outcomes"])
    assert lead["stats"]["hedges"] > 0


def test_a_swap_mid_flight_reaches_every_rank_of_each_replica(world):
    lead = world["ranks"][0]["router"]["swap"]
    assert lead["stats"]["swaps"] == 1
    ids = [o["item_ids"] for o in lead["outcomes"] if o["status"] == "ok"]
    assert all(o["status"] == "ok" for o in lead["outcomes"])
    assert any(i.min() >= SWAP_OFFSET for i in ids) and any(i.max() < SWAP_OFFSET for i in ids)
    for r in world["ranks"]:
        assert "raised" not in r["router"]["swap"]


def test_close_with_tickets_in_flight_stops_every_follower(world):
    lead = world["ranks"][0]["router"]["close"]
    assert {o["status"] for o in lead["outcomes"]} <= {"ok", "error"}
    assert all(o["error"] == "router shutdown" for o in lead["outcomes"]
               if o["status"] == "error")
    assert world["ranks"][1]["router"]["close"]["batches"] >= 0
    assert world["ranks"][2]["router"]["close"]["served"] >= 0
    assert world["ranks"][3]["router"]["close"]["batches"] >= 0


def test_an_idle_replica_keeps_its_followers_past_the_control_timeout(world):
    """Both replicas sit idle for twice their control groups' and the link's
    timeout between two halves of the traffic: each leader's keep-alive
    headers hold its follower, and rank 0's on the link hold replica 1's
    leader, so no rank raises and the second half is served too (its
    answers bitwise the single-device engine's: the parametrized test
    above)."""
    ranks = [r["router"]["idle"] for r in world["ranks"]]
    lead = ranks[0]
    assert lead["idle_s"] >= IDLE_S > IDLE_CONTROL_S
    assert all(o["status"] == "ok" for o in lead["outcomes"]) and not lead["quarantined"]
    assert lead["keepalives"] >= 2 and ranks[2]["keepalives"] >= 2
    assert lead["link_keepalives"] >= 2
    assert ranks[1]["keepalives"] == ranks[3]["keepalives"] == 0
    assert all("raised" not in r and r["mesh_error"] is None for r in ranks)
    first = {o["batch"][0] for o in lead["outcomes"][:ROUTER_REQUESTS // 2]}
    later = {o["batch"][0] for o in lead["outcomes"][ROUTER_REQUESTS // 2:]}
    assert max(first) < min(later)           # served after the pause, in new batches
    assert ranks[1]["batches"] >= 2 and ranks[3]["batches"] >= 1


def test_the_world_ran_within_its_budget(world):
    assert world["spawn_s"] < SPAWN_TIMEOUT


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "worker":
    sys.path.insert(0, str(ROOT / "src"))
    worker(sys.argv[2])
