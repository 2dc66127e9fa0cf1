#!/usr/bin/env python3
"""Time the two top-k kernels of one tree of the port and measure their
near-full accuracy, for comparing two commits on the same card.

    python3 topk_ab.py SRC LABEL

``SRC`` is a tree's ``src`` directory (``src`` for this checkout; a parent
commit unpacked with ``git archive`` into a gitignored directory for the
other side); the near-full inputs come from that tree's
``repro_torch.testing.ragged_topk_inputs``, the card tests' own builder.  Run the two sides in turns in one machine session (parent,
change, change, parent): each run builds its tree's kernels into that
tree's own ``build/``.  Prints one JSON line: for every payload,
approx_topk (k = 20) and persistent_round (k_sample 20 + k_prov 100) ms at
B = 256, k_q = 500, N = 10^6, and, at the near-full card test's shape
(33 x 500 x 257, k = 256, noise, mask, anchors), the kernel's worst error
against float64 over cuBLAS fp32's on the dequantized payload for the
card test's seed (789) and seeds 0-7, and at that seed cuBLAS's worst
error when the same entries are computed inside a 256 x 4,096 product,
over its error at the small shape.  Needs one CUDA card.
"""

import json
import sys


def main() -> int:
    src, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, src)
    import torch

    if not torch.cuda.is_available():
        print("topk_ab: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels.approx_topk.ops import approx_topk_op
    from repro_torch.kernels.approx_topk.persistent import persistent_round_op
    from repro_torch.kernels.approx_topk.quant import (QuantizedRanc, as_payload, dequantize,
                                                       unpacked_codes)
    from repro_torch.testing import ragged_topk_inputs

    dev = torch.device("cuda")

    def cuda_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    e = torch.randn((256, 500), generator=g, device=dev)
    r = torch.randn((500, 1_000_000), generator=g, device=dev)
    anchors = torch.randint(0, 1_000_000, (256, 100), generator=g, device=dev, dtype=torch.int32)
    prov = torch.rand((256, 1_000_000), generator=g, device=dev) < 0.1
    payloads = ("float32", "int8", "bfloat16", "fp8", "int4")
    out = {"label": label}
    for dtype in payloads:
        pay = as_payload(r, dtype)
        out[f"approx_{dtype}_k20_ms"] = cuda_ms(lambda: approx_topk_op(e, pay, anchors, 20))
        out[f"persistent_{dtype}_ms"] = cuda_ms(lambda: persistent_round_op(
            e, pay, k_sample=20, k_prov=100, anchors=anchors, prov_mask=prov))
        del pay
    del r, prov

    def near_full(seed):   # the near-full card test's inputs
        return ragged_topk_inputs(dev, 33, 500, 257, seed)

    def worst(v, i, exact, live):
        return (v.double() - exact.gather(1, i.long())).abs()[live].max().item()

    ratios, embedded = {}, {}
    for seed in [789] + list(range(8)):
        ee, rr, noise, mask, anc = near_full(seed)
        for dtype in payloads:
            pay = as_payload(rr, dtype)
            kv, ki = approx_topk_op(ee, pay, anc, 256, noise=noise, mask=mask, n_valid=252)
            coded = isinstance(pay, QuantizedRanc)
            exact = ee.double() @ (unpacked_codes(pay) if coded else pay).double()
            if coded:
                exact = exact * pay.col_scales().double()[None, :]
            exact += noise.double()
            cublas = torch.matmul(ee, dequantize(pay) if coded else pay.float()) + noise
            live = kv > -1e29
            err_cublas = worst(cublas.gather(1, ki.long()), ki, exact, live)
            ratios.setdefault(dtype, {})[seed] = worst(kv, ki, exact, live) / err_cublas
            if seed == 789:
                # the same entries of cuBLAS's product inside a 256 x 4,096 one
                big_e = torch.zeros((256, 500), device=dev)
                big_e[:33] = ee
                big_r = torch.zeros((500, 4096), device=dev)
                big_r[:, :257] = dequantize(pay) if coded else pay.float()
                inside = torch.matmul(big_e, big_r)[:33, :257] + noise
                embedded[dtype] = worst(inside.gather(1, ki.long()), ki, exact, live) / err_cublas
    out["near_full_kernel_over_cublas"] = ratios
    out["cublas_embedded_over_small"] = embedded
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
