#!/usr/bin/env python3
"""Time one tree's single-device ADACUR search at the serving configuration,
for comparing two commits on the same card.

    python3 engine_ab.py SRC LABEL [REPS]

``SRC`` is a tree's ``src`` directory (``src`` for this checkout; another
commit unpacked with ``git archive`` into a gitignored directory for the
other side).  Run the sides in turns in one machine session (parent,
change, change, parent): each run builds its tree's kernels into that
tree's own ``build/``.  The search is the sharded phase's configuration of
``chip_smoke.py`` on one device: the serve domain's index (N = 10^6, k_q =
500), B = 256 query ids, budget 200 in 5 rounds, fp32 and int8 payloads,
staged and persistent round kernels, scored through the domain's tabulated
600 x 10^6 matrix.  Prints one JSON line: the card's name and power limit,
and for each configuration the median and the minimum of ``REPS`` (default
7) timed searches after one warm-up, in ms (wall clock around a search
that ends with a device synchronize).  Needs one CUDA card.
"""

import json
import statistics
import subprocess
import sys
import time


def main() -> int:
    src, label = sys.argv[1], sys.argv[2]
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 7
    sys.path.insert(0, src)
    import torch

    if not torch.cuda.is_available():
        print("engine_ab: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core import prng
    from repro_torch.core.engine import AdaCURRetriever
    from repro_torch.core.scorer import TabulatedScorer
    from repro_torch.launch.serve import build_domain

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    ce, index = build_domain(1_000_000, dev)
    table = ce.full_matrix(torch.arange(600, device=dev))
    qids = torch.arange(500, 756, device=dev) % 600
    indexes = {"float32": index, "int8": index.quantize("int8")}
    out = {"label": label, "card": card.strip(), "b": 256, "n_items": index.n_items}
    for payload, idx in indexes.items():
        for round_kernel in ("staged", "persistent"):
            cfg = AdaCURConfig(k_anchor=100, n_rounds=5, budget_ce=200, strategy="topk",
                               k_retrieve=100, loop_mode="fori", use_fused_topk=True,
                               payload_dtype=payload, round_kernel=round_kernel)
            retriever = AdaCURRetriever.from_index(idx, TabulatedScorer(table), cfg)
            retriever.search(qids, prng.PRNGKey(5))
            torch.cuda.synchronize()
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                retriever.search(qids, prng.PRNGKey(5))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out[f"{payload} {round_kernel}"] = dict(median_ms=statistics.median(times),
                                                    min_ms=min(times))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
