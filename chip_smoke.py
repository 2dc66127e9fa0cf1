#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ADACUR on one GPU and check it.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py            # the full check (builds the kernels)
    python3 chip_smoke.py --quick    # build + kernel checks at small shapes

Phases (one JSON line each):

1. ``env``: torch/CUDA versions, the card's name and power limit, kernel
   build seconds and ptxas resource lines.
2. ``kernel:approx_topk``: the CUDA kernel against its plain PyTorch version
   on the card at the serving shape (B=256, k_q=500, N=10^6; fp32 and int8;
   k=20 and k=100), plus a noise/mask/anchors/n_valid case with under-filled
   rows at N=65,536; kernel, plain and library (torch.matmul + torch.topk)
   times beside the bound.
3. ``kernel:persistent_round``: both accumulators at the same shapes, held
   to the plain version and bitwise to two approx_topk calls.
4. ``serve``: the serve CLI's domain at full size (600 queries, 10^6 items,
   AnchorIndex over anchor queries 0..499 built on the card) answering 600
   requests through ``AdaCURService(max_batch=256)`` for fp32 staged, fp32
   persistent and int8 staged; launch counts, CE calls against the plan,
   error responses, latency and recall@{1,10,100}.
5. ``engine_cpu_vs_card``: the same search on the card (kernels) and on the
   CPU (plain versions), N=20,000, B=64: top-k overlap >= 0.99.

Then the card's ``name, power.limit`` line, a ``kernels`` summary line, and
last the result line.  Any failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

PEAK_FP32_FLOPS = 67e12      # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
REPLACES = {
    "approx_topk": "src/repro/kernels/approx_topk/kernel.py:74",
    "persistent_round": "src/repro/kernels/approx_topk/persistent.py:232",
}
CUPTI_BOOKKEEPING = ("Command Buffer Full", "Buffer Flush", "Activity Buffer Request")
SOURCES = {
    "approx_topk": "src/repro_torch/csrc/approx_topk.cu",
    "persistent_round": "src/repro_torch/csrc/persistent_round.cu",
}


class CheckFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    from repro_torch.kernels.approx_topk.quant import QuantizedRanc

    total = 0
    for t in ts:
        if t is None:
            continue
        total += t.nbytes if isinstance(t, QuantizedRanc) else t.numel() * t.element_size()
    return total


def make_inputs(b, k_q, n, gen, dev):
    import torch

    from repro_torch.kernels.approx_topk.quant import quantize_ranc

    e_q = torch.randn((b, k_q), generator=gen, device=dev)
    r = torch.randn((k_q, n), generator=gen, device=dev)
    anchors = torch.randint(0, n, (b, 100), generator=gen, device=dev, dtype=torch.int32)
    return e_q, {"float32": r, "int8": quantize_ranc(r)}, anchors


def phase_approx_topk(shape, gen, dev, reps):
    import torch

    from repro_torch.kernels.approx_topk.ops import approx_topk_op, approx_topk_plain
    from repro_torch.kernels.approx_topk.quant import dequantize
    from repro_torch.kernels.approx_topk.ref import dense_scores
    from repro_torch.testing import topk_report

    b, k_q, n = shape
    e_q, payloads, anchors = make_inputs(b, k_q, n, gen, dev)
    rows, worst = [], 0.0
    for dtype, pay in payloads.items():
        r_dense = pay if dtype == "float32" else dequantize(pay)
        scores = dense_scores(e_q, pay, anchors)
        for k in (20, 100):
            kv, ki = approx_topk_op(e_q, pay, anchors, k)
            pv, pi = approx_topk_plain(e_q, pay, anchors, k, tile=8192)
            torch.cuda.synchronize()
            rep = topk_report(ki, kv, pi, pv, scores)
            check(rep["ok"], f"approx_topk {dtype} k={k} disagrees with its plain version: {rep}")
            worst = max(worst, rep["max_abs_err"])
            ms = cuda_ms(lambda: approx_topk_op(e_q, pay, anchors, k), reps)
            plain_ms = cuda_ms(lambda: approx_topk_plain(e_q, pay, anchors, k, tile=8192), 1)
            lib_ms = cuda_ms(lambda: torch.topk(torch.matmul(e_q, r_dense), k, dim=1), reps)
            b_ms, b_by = bound(nbytes(e_q, pay, anchors) + b * k * 8, 2.0 * b * k_q * n)
            rows.append(dict(payload=dtype, k=k, kernel_ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, **rep))
        del scores
    # noise / mask / anchors / n_valid, with under-filled rows
    n2 = 65536
    e2, pays2, anc2 = make_inputs(b, k_q, n2, gen, dev)
    noise = -torch.log(-torch.log(torch.rand((b, n2), generator=gen, device=dev).clamp_min(1e-30)))
    mask = torch.rand((b, n2), generator=gen, device=dev) < 0.3
    mask[0] = True                      # row 0: nothing valid
    mask[1] = True
    mask[1, [5, 77, 4000]] = False      # row 1: three valid items
    for dtype, pay in pays2.items():
        kw = dict(noise=noise, mask=mask, n_valid=60000)
        kv, ki = approx_topk_op(e2, pay, anc2, 20, **kw)
        pv, pi = approx_topk_plain(e2, pay, anc2, 20, tile=4096, **kw)
        rep = topk_report(ki, kv, pi, pv, dense_scores(e2, pay, anc2, **kw))
        check(rep["ok"], f"approx_topk {dtype} masked case disagrees: {rep}")
        check(torch.equal(ki[0].cpu(), torch.arange(20, dtype=torch.int32)),
              f"fully masked row must return ids 0..19, got {ki[0].tolist()}")
        ids1 = ki[1].cpu()
        check(len(set(ids1.tolist())) == 20, f"under-filled row repeats ids: {ids1.tolist()}")
        worst = max(worst, rep["max_abs_err"])
        rows.append(dict(payload=dtype, k=20, case="noise+mask+anchors+n_valid", n=n2, **rep))
    return rows, worst


def phase_persistent(shape, gen, dev, reps):
    import torch

    from repro_torch.kernels.approx_topk.ops import approx_topk_op
    from repro_torch.kernels.approx_topk.persistent import (
        persistent_round_op, persistent_round_plain,
    )
    from repro_torch.kernels.approx_topk.quant import dequantize
    from repro_torch.kernels.approx_topk.ref import dense_scores
    from repro_torch.testing import topk_report

    b, k_q, n = shape
    e_q, payloads, anchors = make_inputs(b, k_q, n, gen, dev)
    prov_mask = torch.rand((b, n), generator=gen, device=dev) < 0.1
    rows, worst = [], 0.0
    for dtype, pay in payloads.items():
        r_dense = pay if dtype == "float32" else dequantize(pay)
        kw = dict(k_sample=20, k_prov=100, anchors=anchors, prov_mask=prov_mask)
        (sv, si), (pv, pi) = persistent_round_op(e_q, pay, **kw)
        (qv, qi), (rv, ri) = persistent_round_plain(e_q, pay, tile=8192, **kw)
        av, ai = approx_topk_op(e_q, pay, anchors, 20)
        bv, bi = approx_topk_op(e_q, pay, None, 100, mask=prov_mask)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(x, y) for x, y in ((sv, av), (si, ai), (pv, bv), (pi, bi)))
        check(bitwise, f"persistent_round {dtype} is not bitwise equal to two approx_topk calls")
        lists = {"sample": ((si, sv), (qi, qv), dict(anchors=anchors)),
                 "prov": ((pi, pv), (ri, rv), dict(mask=prov_mask))}
        for name, (x, y, sup) in lists.items():
            rep = topk_report(x[0], x[1], y[0], y[1], dense_scores(e_q, pay, **sup))
            check(rep["ok"], f"persistent_round {dtype} {name} disagrees with its plain version: {rep}")
            worst = max(worst, rep["max_abs_err"])
        ms = cuda_ms(lambda: persistent_round_op(e_q, pay, **kw), reps)
        plain_ms = cuda_ms(lambda: persistent_round_plain(e_q, pay, tile=8192, **kw), 1)

        def library():
            s = torch.matmul(e_q, r_dense)
            torch.topk(s, 20, dim=1)
            torch.topk(s.masked_fill(prov_mask, -1e30), 100, dim=1)

        lib_ms = cuda_ms(library, reps)
        b_ms, b_by = bound(nbytes(e_q, pay, anchors, prov_mask) + b * 120 * 8,
                           2.0 * b * k_q * n)
        rows.append(dict(payload=dtype, k_sample=20, k_prov=100, kernel_ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by, bitwise_vs_staged=bitwise))
    return rows, worst


def profile_search(retriever, qids, key) -> dict:
    """One search under torch.profiler: device time by kernel name, the
    device-busy share of the search's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        retriever.search(qids, key)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # device-side rows only: an operator's row repeats its kernels'
        # time, and CUPTI's own buffer bookkeeping is no work of the search
        if ev.device_type != DeviceType.CUDA or ev.key in CUPTI_BOOKKEEPING:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us:
            rows.append((us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms if wall_ms else None,
            "top": [{"name": k[:90], "ms": us / 1e3, "calls": c} for us, k, c in rows[:12]]}


def phase_serve(dev):
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core import prng, sampling
    from repro_torch.core.engine import AdaCURRetriever, ce_call_plan
    from repro_torch.core.scorer import SyntheticScorer
    from repro_torch.eval.metrics import exact_topk, topk_recall
    from repro_torch.launch.serve import AdaCURService, build_domain, drive

    n_items = 1_000_000
    t0 = time.perf_counter()
    ce, index = build_domain(n_items, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    served_q = torch.arange(500, 600, device=dev)
    _, gt = exact_topk(ce.full_matrix(served_q), 100)
    gt = gt.cpu()
    noise_ms = cuda_ms(lambda: sampling.blocked_gumbel(prng.PRNGKey(1), 256, n_items, device=dev), 2)
    int8_index = index.quantize("int8")
    results, launches = [], {"approx_topk": 0, "persistent_round": 0}
    for label, payload, round_kernel in (("fp32 staged", "float32", "staged"),
                                         ("fp32 persistent", "float32", "persistent"),
                                         ("int8 staged", "int8", "staged")):
        cfg = AdaCURConfig(k_anchor=100, n_rounds=5, budget_ce=200, strategy="topk",
                           k_retrieve=100, loop_mode="fori", use_fused_topk=True,
                           payload_dtype=payload, round_kernel=round_kernel)
        scorer = SyntheticScorer(ce)
        svc = AdaCURService(
            retriever=AdaCURRetriever.from_index(
                int8_index if payload == "int8" else index, scorer, cfg),
            max_batch=256)
        kernels.reset_launches()
        served = drive(svc, 600)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        n_search = len(svc.batch_log)
        errors = [r.error for r in served if r.status != "ok"]
        check(not errors, f"serve {label}: {len(errors)} error responses, first: {errors[:1]}")
        check(len(served) == 600, f"serve {label}: {len(served)} responses for 600 requests")
        plan = ce_call_plan(cfg)
        for bl in svc.batch_log:
            check(bl["ce_calls"] == plan * bl["bucket"],
                  f"serve {label}: measured CE {bl['ce_calls']} != plan {plan} x {bl['bucket']}")
        expect = ({"approx_topk": 5 * n_search, "persistent_round": 0}
                  if round_kernel == "staged"
                  else {"approx_topk": n_search, "persistent_round": 4 * n_search})
        check(counts == expect, f"serve {label}: launches {counts}, expected {expect}")
        for name in launches:
            launches[name] += counts[name]
        retrieved = torch.as_tensor(np.stack([r.item_ids for r in served]))
        rows = gt[[r.query_id - 500 for r in served]]
        recall = {f"recall@{k}": topk_recall(retrieved, rows, k) for k in (1, 10, 100)}
        for r in served:
            check(r.item_ids.shape == (100,) and np.isfinite(r.scores).all()
                  and ((r.item_ids >= 0) & (r.item_ids < n_items)).all(),
                  f"serve {label}: malformed response for query {r.query_id}")
        secs = [bl["seconds"] for bl in svc.batch_log]
        results.append(dict(
            config=label, requests=len(served), searches=n_search,
            buckets=[bl["bucket"] for bl in svc.batch_log],
            batch_p50_ms=float(np.percentile(secs, 50) * 1e3),
            batch_p99_ms=float(np.percentile(secs, 99) * 1e3),
            per_search_ms=float(np.mean(secs) * 1e3),
            launches=counts, measured_ce_per_request=served[0].measured_ce_calls,
            ce_plan=plan, errors=0, **recall,
        ))
    cfg = AdaCURConfig(k_anchor=100, n_rounds=5, budget_ce=200, strategy="topk",
                       k_retrieve=100, loop_mode="fori", use_fused_topk=True)
    profiled = profile_search(AdaCURRetriever.from_index(index, SyntheticScorer(ce), cfg),
                              torch.arange(500, 756, device=dev) % 600, prng.PRNGKey(5))
    return dict(index_build_s=build_s, round0_noise_ms_B256=noise_ms, n_items=n_items,
                configs=results, profile_fp32_staged_B256=profiled), launches


def phase_engine_cpu_vs_card(dev):
    """The same search on the card and on the CPU.  The early-exit persistent
    config runs the software-pipelined monitored loop: every sweep launches
    ``persistent_round`` with both lists (sample + provisional monitor), so
    the card makes one launch per round done and one ``approx_topk`` (the
    rerank) in all.  It stops before its last round, on both devices alike.
    It uses the full regularized pinv, whose search a one-ulp change of the
    payload leaves unchanged (``tests/test_torch_engine.py::
    test_full_pinv_search_is_stable_under_rounding``); the incremental
    bordered update amplifies fp32 rounding, so the card's cuBLAS/cuSOLVER
    rounding alone can move its top-k."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core import prng
    from repro_torch.core.engine import engine_search
    from repro_torch.core.index import AnchorIndex
    from repro_torch.core.scorer import SyntheticScorer
    from repro_torch.data.synthetic import make_synthetic_ce
    from repro_torch.testing import topk_overlap

    ce = make_synthetic_ce(prng.PRNGKey(7), n_queries=264, n_items=20000, device="cpu")
    index = AnchorIndex.build(ce.score_block, torch.arange(200), torch.arange(20000))
    q = torch.arange(200, 264)
    out = []
    base = dict(k_anchor=40, n_rounds=4, budget_ce=80, k_retrieve=30, loop_mode="fori",
                use_fused_topk=True)
    for kw in (dict(), dict(round_kernel="persistent"), dict(payload_dtype="int8"),
               dict(round_kernel="persistent", early_exit_tol=0.5, n_rounds=8,
                    incremental_pinv=False)):
        cfg = AdaCURConfig(**{**base, **kw})
        pay = index.quantize(cfg.payload_dtype).r_anc
        key = prng.PRNGKey(3)
        cpu = engine_search(SyntheticScorer(ce), pay, q, cfg, key)
        kernels.reset_launches()
        card = engine_search(SyntheticScorer(ce.to(dev)), pay.to(dev), q.to(dev), cfg, key)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        ov = topk_overlap(cpu.topk_idx, card.topk_idx)
        check(ov >= 0.99, f"engine card vs CPU overlap {ov} < 0.99 for {kw}")
        if cfg.early_exit_tol > 0.0:
            check(card.rounds_done == cpu.rounds_done < cfg.n_rounds,
                  f"early exit: card {card.rounds_done} rounds, CPU {cpu.rounds_done}, "
                  f"of {cfg.n_rounds}")
            expect = {"approx_topk": 1, "persistent_round": int(card.rounds_done)}
            check(counts == expect, f"early-exit persistent launches {counts}, expected {expect}")
        out.append(dict(config=kw or "fp32 staged", overlap=ov, launches=counts,
                        rounds_done_card=int(card.rounds_done),
                        rounds_done_cpu=int(cpu.rounds_done)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels at small shapes only")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = smi_line()
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in info["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, info in build.build_info.items()}
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "build_s": build_s, "ptxas": ptxas})

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    shape = (64, 128, 16384) if args.quick else (256, 500, 1_000_000)
    reps = 2 if args.quick else 3
    summary = {}
    try:
        rows, err = phase_approx_topk(shape, gen, dev, reps)
        emit({"phase": "kernel:approx_topk", "shape": shape, "cases": rows})
        summary["approx_topk"] = (rows[0], err)
        rows, err = phase_persistent(shape, gen, dev, reps)
        emit({"phase": "kernel:persistent_round", "shape": shape, "cases": rows})
        summary["persistent_round"] = (rows[0], err)
        launches = {"approx_topk": 0, "persistent_round": 0}
        if not args.quick:
            serve, launches = phase_serve(dev)
            emit({"phase": "serve", **serve})
            emit({"phase": "engine_cpu_vs_card", "runs": phase_engine_cpu_vs_card(dev)})
        for name, n in launches.items():
            check(args.quick or n > 0, f"{name} was never launched on the main path")
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": err, "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
         "library_ms": row["library_ms"]}
        for name, (row, err) in summary.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
