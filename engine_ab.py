#!/usr/bin/env python3
"""Time one tree's single-device ADACUR search, for comparing two commits on
the same card.

    python3 engine_ab.py SRC LABEL [--reps N]
    python3 engine_ab.py SRC LABEL --small-batch [--reps N] [--cache DIR]

``SRC`` is a tree's ``src`` directory (``src`` for this checkout; another
commit unpacked with ``git archive`` into a gitignored directory for the
other side).  Run the sides in turns in one machine session (parent,
change, change, parent): each run builds its tree's kernels into that
tree's own ``build/``.  Prints one JSON line: the card's name and power
limit, and a time in ms for each configuration (wall clock around a search
that ends with a device synchronize, after one warm-up search).  Needs one
CUDA card.

Default: the sharded phase's configuration of ``chip_smoke.py`` on one
device: the serve domain's index (N = 10^6, k_q = 500), B = 256 query ids,
budget 200 in 5 rounds, fp32 and int8 payloads, staged and persistent
round kernels, scored through the domain's tabulated 600 x 10^6 matrix;
the median and the minimum of ``--reps`` (default 7) searches.

``--small-batch``: the searches whose batch is small, the mean of
``--reps`` (default 16) searches: (1) ``dlrm-mlperf`` retrieval at B = 1,
``chip_smoke.py``'s ``recsys_retrieval`` engine search (full width, tables
capped at 2^24 rows, R_anc of 500 anchor contexts over 10^6 candidates,
``RETRIEVAL_CFG`` with the fused kernels; one search per context of 16);
(2) the router's searches at B = 16 and 32 (the serve domain, budget 200
in 5 rounds, fused, staged, the synthetic CE).  With ``--cache DIR`` the
DLRM R_anc (2 GB) is built once and read back from ``DIR`` by later runs:
it depends on neither side's engine.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def _timed(fn, reps):
    import torch

    fn(0)
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def serving(dev, reps) -> dict:
    import torch

    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core import prng
    from repro_torch.core.engine import AdaCURRetriever
    from repro_torch.core.scorer import TabulatedScorer
    from repro_torch.launch.serve import build_domain

    ce, index = build_domain(1_000_000, dev)
    table = ce.full_matrix(torch.arange(600, device=dev))
    qids = torch.arange(500, 756, device=dev) % 600
    indexes = {"float32": index, "int8": index.quantize("int8")}
    out = {"b": 256, "n_items": index.n_items}
    for payload, idx in indexes.items():
        for round_kernel in ("staged", "persistent"):
            cfg = AdaCURConfig(k_anchor=100, n_rounds=5, budget_ce=200, strategy="topk",
                               k_retrieve=100, loop_mode="fori", use_fused_topk=True,
                               payload_dtype=payload, round_kernel=round_kernel)
            retriever = AdaCURRetriever.from_index(idx, TabulatedScorer(table), cfg)
            times = _timed(lambda i: retriever.search(qids, prng.PRNGKey(5)), reps)
            out[f"{payload} {round_kernel}"] = dict(median_ms=statistics.median(times),
                                                    min_ms=min(times))
    return out


def small_batch(dev, reps, cache) -> dict:
    import torch

    from repro_torch.configs import dlrm_mlperf
    from repro_torch.configs.base import AdaCURConfig, replace
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.core import prng
    from repro_torch.core.engine import AdaCURRetriever, engine_search
    from repro_torch.core.scorer import SyntheticScorer
    from repro_torch.launch import steps
    from repro_torch.launch.serve import build_domain
    from repro_torch.models.recsys import dlrm

    out = {}
    cfg = dlrm_mlperf.capped()
    params = steps.recsys_init(cfg, seed=0, device=dev)
    n_cand = RECSYS_SHAPES["retrieval_cand"].n_candidates
    path = os.path.join(cache, "dlrm_r_anc.pt") if cache else None
    if path and os.path.exists(path):
        r_anc = torch.load(path).to(dev)
    else:
        anchors = steps.recsys_inputs(cfg, steps.K_Q, 2, dev)
        r_anc = steps.anchor_scores(params, cfg, anchors, n_cand)
        if path:
            os.makedirs(cache, exist_ok=True)
            torch.save(r_anc.cpu(), path)
    ctx = steps.recsys_inputs(cfg, reps, seed=7, device=dev)
    ecfg = replace(steps.RETRIEVAL_CFG, use_fused_topk=True)

    def sf(q, idx):
        return dlrm.score_candidates(params, q["dense"], q["sparse"], idx, cfg)

    def dlrm_search(i):
        q = {"dense": ctx["dense"][i:i + 1], "sparse": ctx["sparse"][i:i + 1]}
        engine_search(sf, r_anc, q, ecfg, prng.PRNGKey(100 + i), n_valid_items=n_cand)

    out["dlrm B=1"] = statistics.mean(_timed(dlrm_search, reps))
    del params, r_anc
    torch.cuda.empty_cache()
    ce, index = build_domain(1_000_000, dev)
    rcfg = AdaCURConfig(k_anchor=100, n_rounds=5, budget_ce=200, strategy="topk",
                        loop_mode="fori", use_fused_topk=True)
    retriever = AdaCURRetriever.from_index(index, SyntheticScorer(ce), rcfg)
    for b in (16, 32):
        qids = torch.arange(500, 500 + b, device=dev)
        out[f"router B={b}"] = statistics.mean(
            _timed(lambda i: retriever.search(qids, prng.PRNGKey(5 + i)), reps))
    return {k: (dict(mean_ms=v) if isinstance(v, float) else v) for k, v in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("src")
    ap.add_argument("label")
    ap.add_argument("--reps", type=int)
    ap.add_argument("--small-batch", action="store_true")
    ap.add_argument("--cache")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("engine_ab: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"label": args.label, "card": card.strip()}
    if args.small_batch:
        out.update(small_batch(dev, args.reps or 16, args.cache))
    else:
        out.update(serving(dev, args.reps or 7))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
