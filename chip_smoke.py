#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ADACUR on one GPU and check it.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py            # the full check (builds the kernels)
    python3 chip_smoke.py --quick    # build + kernel checks at small shapes

Phases (one JSON line each):

1. ``env``: torch/CUDA versions, the card's name and power limit, kernel
   build seconds and ptxas resource lines, the count of ``HGMMA``
   instructions in the flash library's SASS (``cuobjdump -sass``), and the
   card's ``mma.sync`` TF32 rate (a register-only loop of
   ``mma.sync.m16n8k8`` TF32 on every SM, built beside the kernels): the
   most the top-k kernels' mainloop can reach.  ptxas must report no
   spill for the top-k and flash kernels, and the bf16 flash kernel must
   hold ``HGMMA`` (the wgmma tensor-core path).
2. ``kernel:approx_topk``: the CUDA kernel against its plain PyTorch version
   on the card at the serving shape (B=256, k_q=500, N=10^6; every payload:
   fp32, int8, bf16, fp8 e4m3, packed int4; k=20 and k=100), plus a
   noise/mask/anchors/n_valid case with under-filled rows at N=65,536;
   kernel, plain and library (dequantize or cast to fp32 + torch.matmul +
   torch.topk, all timed) times beside the tensor-core bound (``bound_ms``:
   the product split into TF32 or bf16 parts at fp32 accuracy, whichever is
   faster), the CUDA-core fp32 one (``bound_simt_ms``) and, at the serving
   shape, the earlier CUDA-core design's kernel time as recorded on an H100
   (``earlier_design_ms_recorded``, a constant, not measured here).  ptxas
   must report no spill for either top-k kernel.  The large-k
   instantiation (k in (256, 1024]) at the serving shape, k = 800 and
   1024, fp32 and int8 (``case: large_k``), and the dual-encoder first
   stage's shape, B = 100 queries x d = 16 over 10^6 items at k = 200 and
   800 (``case: dual_encoder``), each against its plain version with
   kernel, plain, library and bound times.
3. ``kernel:persistent_round``: both accumulators at the same shapes and
   payloads, held to the plain version and bitwise to two approx_topk calls.
4. ``serve``: the serve CLI's domain at full size (600 queries, 10^6 items,
   AnchorIndex over anchor queries 0..499 built on the card) answering 600
   requests through ``AdaCURService(max_batch=256)`` for every payload,
   staged and persistent; launch counts, CE calls against the plan, error
   responses, latency, recall@{1,10,100}, the payload's bytes and the
   engine's slab bytes (``engine_slab_bytes``).
4a. ``retrievers``: the paper's budget-matched comparison
   (``eval.harness.quality_matrix``) on the same domain: ADACUR, ANNCUR,
   DE retrieve-and-rerank, the DE-hybrid and the BM25-hybrid (BM25 over
   the domain's ``lexical_signatures``, seed 3), budget 200 in 5 rounds
   (k_anchor 100), k_retrieve 100, fused, fp32, shortlists of 800, the
   tabulated 600 x 10^6 fp32 matrix (2.4 GB) on the card, 100 test
   queries; per method planned and measured CE (gated equal), recall@
   {1,10,100} and recall/MRR/NDCG against the CE's top-1 (printed), wall
   microseconds a query and kernel launches (approx_topk gated > 0); the
   fused round body's (B, N) float count (gated 0).  Both hybrids again
   in subset mode (``subset_mode``): measured CE = plan and top-k ids and
   scores bitwise equal to the full-corpus search masked to the union of
   the shortlists (gated), microseconds a query beside mask mode's.
4b. ``anytime``: 256 requests through ``AdaCURService(max_batch=256)`` over
   an ``anytime=True`` retriever at N = 10^6, with every deadline already
   past (one round, degraded, CE = ``ce_call_plan(cfg, 1)`` a request) and
   with none (five rounds, not degraded).
4c. ``index_lifecycle``: the AnchorIndex lifecycle on the same domain
   (k_q = 500, N = 10^6): a resumable build interrupted after 2 of 4
   blocks and resumed (scores the 2 missing blocks; R_anc bit-equal to the
   domain's); save and load of every payload (bytes on disk, seconds and
   GB/s; ``topk`` at B = 256, k = 100 and a B = 256 persistent engine
   search bit-equal after the load); ``with_capacity(2^20)``,
   ``remove_items`` of every 100th id and ``add_items`` of them back (fp32
   held against ``from_r_anc`` over the same columns: bytes, ids, topk and
   engine results, CE = plan; the coded payloads' bytes held against the
   same mutation on the CPU, and a search over the mutated index);
   ``swap_index`` with 64 requests queued (answered under the old index,
   no removed id after).
4d. ``router``: the fault-tolerant serving tier over the same index
   (one copy, shared by every replica): ``Router`` over ``AdaCURService``
   replicas, each on its own CUDA stream and thread, each with its own
   anytime retriever and ``FaultyScorer`` (budget 200 in 5 rounds, k_anchor
   100, fused, ``max_batch=64``, buckets [16, 32, 64]), 256 requests a
   scenario: capacity (closed loop; 1 and 2 replicas, staged and
   persistent: QPS, p50/p99, device-busy share, peak memory), then Poisson
   arrivals at half the 2-replica QPS: baseline, scorer_fault (replica 0
   quarantined, every request ok), slow_replica (hedged; p99 <= 2x the
   baseline's + 50 ms), swap_midflight (ids + 10^7, every 100th removed, at
   admission 128: no mixed or stale answer, no removed id) and
   deadline_degraded (1 <= rounds < 5 where degraded).  Every scenario:
   one terminal outcome per request, ``router.stats`` adds up, CE = plan x
   bucket per batch.  Then degraded answers bitwise equal to
   ``search(n_rounds=rounds_completed)`` (prefix consistency), under a
   faulthandler watchdog.
4e. ``sharded``: the sharded engine on one card.  The serve domain's index
   (N = 10^6, k_q = 500) is saved to local disk and loaded by a 2 (data) x
   2 (items) world of ranks on ``cuda:0`` (gloo over CUDA tensors; NCCL
   refuses two ranks on one card), each reading only its columns
   (``AnchorIndex.load(path, mesh)``), int8 quantized on the ranks; each
   rank's resident payload is gated at 1.1x the ideal N / items.  For fp32
   and int8, staged and persistent, a B = 256 search (budget 200 in 5
   rounds; fp32 staged and int8 persistent also at B = 200, 100 rows a
   data shard) through the tabulated 600 x 10^6 matrix, and fp32 staged
   through the synthetic CE itself, must give every rank the
   single-device engine's ``topk_idx``, ``topk_scores``, ``anchor_idx``
   and ``rounds_done`` bit for bit, with CE = plan.  Times,
   launches and collectives per rank, beside the single-device search's
   ms.  Then ``ce-tiny`` (full width, fp32) through ``DeviceCEScorer``
   under a 1 x 2 mesh over 4,096 items: the single-device
   ``DeviceCEScorer``'s and ``CrossEncoderScorer``'s ids, CE = plan; a
   probe of the gloo collectives on CUDA tensors; NCCL's error for two
   ranks on one card; and the serve CLI under ``torchrun
   --nproc-per-node 1 ... --mesh 1x1`` on NCCL.  The ``kernel:*`` phases
   hold both top-k kernels at a rank's shape too (``case: sharded``: B =
   128 over one item shard's slab, fp32 and int8, the selected mask).
4f. ``retrievers_cpu_vs_card``: the five methods and both hybrids in
   subset mode at N = 20,000, B = 64, fp32 and int8, full pinv, on the
   card (kernels) and on the CPU (plain versions): top-k overlap >= 0.99
   and measured CE equal, per method.
5. ``engine_cpu_vs_card``: the same search on the card (kernels) and on the
   CPU (plain versions), N=20,000, B=64, fp32, int8, bf16, fp8 and int4,
   staged and persistent, with the incremental pinv the serve path runs:
   top-k overlap >= 0.99, launch counts.
6. ``kernel:flash_attention``: the CUDA kernel against its plain version on
   the card at the cross-encoder serving shape (64 and 1024 pairs, L=64,
   8/4 heads, hd=32, bf16 and fp32, real pair lengths plus length-0 pad
   rows, which must come out as zeros), the Qwen3-8B attention shape
   (B=2, L=2048, 32/8 heads, hd=128; bf16 causal and not, fp32 not) and a
   decode chunk (Lq=64 < Lk=192, causal); kernel, plain, library (SDPA with
   a boolean mask) and bound times; bf16 rows also ``bound_split_ms``, the
   bound of the kernel's own tensor-core work (P V three times: p in three
   bf16 terms, 2x the FLOPs).
7. ``serve_real_ce``: ``ce-tiny`` at full width in bf16 over a ZESHEL-like
   corpus of 10,000 items, its AnchorIndex built from the CE itself on the
   card, answering 200 requests through ``AdaCURService(max_batch=16)``
   without and with a ``CachingScorer``; CE calls against the plan, launch
   counts (flash_attention == n_layers x forwards), error responses,
   latency, CE forwards/s and recall@{1,10,50} against the exact CE top-k.
8. ``ce_cpu_vs_card``: 256 pairs scored by ``ce-tiny`` on the card (kernel)
   and on the CPU (plain version) with the same weights: fp32 max |dscore|
   <= 1e-4 x max |score|; bf16 printed.
9. ``kernel:embedding_bag``: the CUDA kernel against its plain version on
   the card: (a) DLRM's per-field lookup at serve_bulk (B=262,144, H=1,
   dim 128, fp32, a 2^24-row table), (b) the same at serve_p99 (B=512),
   (c) multi-hot B=65,536, H=32, sum and mean, fp32 and bf16; kernel,
   plain, library (``F.embedding_bag``) and bound times.  H=1 must be
   bitwise equal; fp32 within 1e-5 abs + 1e-5 rel, bf16 1e-6 + 2^-7 (one
   ulp).
9a. ``kernel:embedding_bag_backward``: the bag's backward kernel (training's
    gradient of the tables; deterministic, no floating-point atomics)
    against its plain version (``index_add_`` in lookup order) for one DLRM
    field at train_batch (B = 65,536, H = 1, dim 128) over (a) a 2^22-row
    table, (b) a 512-row one (128 lookups a row) and (c) Criteo field 5's
    3-row one (~21,845 lookups a row): max |d| <= 1e-5 x max |grad|, bitwise
    equal to ``ref.embedding_bag_backward_emulated`` (the kernel's order of
    additions) and across two calls; kernel, plain, library (``zeros`` +
    ``index_add_``) and bound times.  The bound is the dense gradient
    written, grad_out and the ids read (``bound_touched_ms``: the touched
    rows only).
10. ``recsys_serve``: ``dlrm-mlperf`` at full width with every table capped
    at 2^24 rows (45.0 GB of fp32 tables on the card), the serve_p99
    (B=512) and serve_bulk (B=262,144) steps of ``build_recsys_serve``:
    median ms a step, TFLOP/s against ``recsys_flops``, 26 bag launches a
    step, peak device memory.
11. ``recsys_retrieval``: R_anc (500 anchor contexts x 1,000,448 padded
    columns, 10^6 valid) built on the card from the same DLRM; 16
    single-context searches through ``build_recsys_retrieval``'s step
    (Algorithm 1, 500 CE calls each) with recall@{1,10,100} against the
    exact DLRM top-100 over 10^6 items (printed, not gated: the weights are
    random); the same 16 through ``engine_search`` with the dict query and
    the fused kernels (approx_topk launches, top-k overlap printed); each
    loop after one warm-up search, ``per_search_ms`` the mean of the 16.
12. ``dlrm_cpu_vs_card``: full width, tables capped at 2^16 rows, 512
    contexts x 64 candidates through ``score_candidates`` on the card
    (kernel) and on the CPU (plain): max |dscore| <= 1e-4 x max |score|
    with TF32 off, and the lookups bitwise equal.

13. ``train``: (1) ``dlrm-mlperf`` at full width, tables capped at 2^22
    rows (12.8 GB a copy; parameters, gradients and both AdamW moments
    ~51 GB), ``build_recsys_train`` at train_batch (B = 65,536): 2 warm-up
    and 10 timed steps (median ms, TFLOP/s against ``model_flops``, peak
    memory, 26 bag forward and 26 backward launches a step, gated), one
    step profiled (the bag backward's device ms a step from its kernels,
    ``bag_backward_device_ms``), finite losses and every table's gradient non-zero
    exactly on the rows a lookup hit (gated); (2) the same step with
    tables capped at 2^16, B = 512, three steps on the card (kernels) and
    on the CPU (plain): losses within 1e-5 relative, parameters within
    1e-5 x the largest |parameter|, TF32 off; (3) two identical 3-step
    runs bitwise equal, ``run_with_recovery`` with a step that raises once
    at step 2 bitwise equal to the uninterrupted run, and
    ``python -m repro_torch.launch.train --arch ce-tiny --steps 30
    --save-every 10`` resumed by ``--steps 50`` bitwise equal to one
    50-step run; (4) flash_attention, approx_topk and persistent_round
    raise on a tensor that requires grad; (5) ce-tiny at train_4k (seq
    4,096) at the largest batch, a multiple of 8, that fits in 80% of the
    card (found from the peak memory of one step at B = 1 and 2): step ms,
    tokens/s, peak memory.
14. ``lm``: the LM family at full width in bf16 with seeded random weights
    drawn on the card (one line an arch, ``lm:<arch>``): qwen3-8b,
    starcoder2-3b, granite-moe-1b-a400m and moonshot-v1-16b-a3b (56.8 GB
    of weights; qwen1.5-110b's 222 GB is not run).  First
    ``lm:flash_prefill_32k``: the flash kernel at Qwen3-8B's prefill_32k
    attention (B = 1, L = 32,768, causal) against its plain version over
    the whole output (gate c), with SDPA's time and the bound.  Per arch:
    (a) decode == prefill: a 2,048-token prefill, token 2,049 decoded into
    its cache, the decode's logits against the 2,049-token prefill's last
    position within atol = rtol = 2e-2 (the reference's own bar, in its
    own test's fp32: the weights drawn again in fp32, moonshot's depth cut
    to fit; MoE at a capacity factor of n_experts / top_k, so nothing
    drops), and on the bf16 model with a norm-wise relative difference
    within 2 x 2^-8 x sqrt(n_layers) (dense) or twice the model's own move
    under one bf16 rounding a layer (MoE, the decode and the shorter
    prefill replaying the full prefill's routing, the flips counted; the
    run on their own routing printed); (b) flash vs ref: every layer's
    attention output on the same q, k, v within the bf16 bound, and the
    final hidden states' relative difference within the same bounds as
    (a) in bf16 (MoE: the flash encode on the ref encode's routing);
    ``build_lm_prefill`` at
    prefill_32k (the largest batch, at most 8, that fits in 80% of the
    card; moonshot one sequence at the longest power-of-two length that
    fits), ``build_lm_decode`` at decode_32k (the largest batch that fits;
    moonshot one sequence at the longest cache that fits) and at long_500k
    (starcoder2-3b and granite: the full 524,288-entry cache): ms a step,
    tokens/s, TFLOP/s against ``model_flops``, peak memory, device-busy
    share, flash launches, the cuts; for qwen3-8b (d)
    ``build_lm_adacur_serve`` at the reference's defaults (N = 10^6, B = 8,
    budget 500 in 5 rounds, k_q = 500) on the bidirectional CE
    (``causal=False``) and a seeded synthetic R_anc: ms a search, its CE
    and e_q @ R_anc split, measured CE == plan, distinct ids < N, each
    row's scores sorted, every returned score within 2 bf16 ulps of a
    direct ``score_tokens`` of its pair, and the flash kernel against its
    plain version at each CE call's batch (400 and 2,000 pairs of 67
    tokens, 32/8 heads, hd 128, non-causal) and on a real call's first and
    last layers' q, k, v.

Then the card's ``name, power.limit`` line, a ``kernels`` summary line (one
entry per kernel and, for the two top-k kernels, per payload: ``approx_topk``
is fp32, ``approx_topk[int8]`` etc. the others), and last the result line.
Any failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

NEG_INF = -1e30              # the ops' suppressed score (kernels/approx_topk/select.py)
PEAK_FP32_FLOPS = 67e12      # H100 SXM, fp32 outside the tensor cores
PEAK_TF32_FLOPS = 494.7e12   # H100 SXM, TF32 tensor cores, dense
PEAK_BF16_FLOPS = 989e12     # H100 SXM, bf16 tensor cores, dense
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
REPLACES = {
    "approx_topk": "src/repro/kernels/approx_topk/kernel.py:74",
    "persistent_round": "src/repro/kernels/approx_topk/persistent.py:232",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:26",
    "embedding_bag": "src/repro/kernels/embedding_bag/kernel.py:26",
    # the bag's gradient: the TPU kernel has no backward, the reference
    # differentiates its gather (jnp.take) with XLA's scatter-add
    "embedding_bag_backward": "src/repro/kernels/embedding_bag/kernel.py:26",
}
CUPTI_BOOKKEEPING = ("Command Buffer Full", "Buffer Flush", "Activity Buffer Request")
SOURCES = {
    "approx_topk": "src/repro_torch/csrc/approx_topk.cu",
    "persistent_round": "src/repro_torch/csrc/persistent_round.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "embedding_bag": "src/repro_torch/csrc/embedding_bag.cu",
    "embedding_bag_backward": "src/repro_torch/csrc/embedding_bag.cu",
}
# kernel_ms of the earlier CUDA-core design of the two top-k kernels (fp32
# FMA tiles, one-at-a-time list inserts) at the serving shape, recorded on
# an H100 80GB HBM3 at 700 W: constants, printed in the phase rows at that
# shape only, for comparison
EARLIER_DESIGN_MS = {
    ("approx_topk", "float32", 20): 24.27, ("approx_topk", "float32", 100): 33.97,
    ("approx_topk", "int8", 20): 21.76, ("approx_topk", "int8", 100): 34.38,
    ("persistent_round", "float32", 20): 41.76, ("persistent_round", "int8", 20): 41.35,
}
FLASH_P_TERMS = 3           # bf16 terms of p in the bf16 flash kernel's P V product
DLRM = "dlrm-mlperf"
PAYLOADS = ("float32", "int8", "bfloat16", "fp8", "int4")
ROUTER_BUCKETS = (16, 32, 64)   # the router phase's batch buckets (B of its searches)
SHARDED_MESH = (2, 2)           # the sharded phase's (data, items) ranks, all on one card
SHARD_ROWS = 256 // SHARDED_MESH[0]   # a data shard's rows of the serving batch
BAG_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-6, 2.0 ** -7)}   # (atol, rtol)


def topk_entry(kernel: str, payload: str) -> str:
    """The kernels line's name of a top-k kernel on one payload: the kernel's
    own name for fp32, ``kernel[payload]`` for the others."""
    return kernel if payload == "float32" else f"{kernel}[{payload}]"


class CheckFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


_LAST_EMIT = [time.perf_counter()]


def emit(obj):
    """Print one JSON line; a phase line also gets ``phase_s``, the wall
    seconds since the line before it."""
    now = time.perf_counter()
    if "phase" in obj:
        obj = {**obj, "phase_s": now - _LAST_EMIT[0]}
    _LAST_EMIT[0] = now
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


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_FP32_FLOPS):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def topk_bounds(dtype, nb, b, k_q, n) -> dict:
    """The fused ops' bounds.  ``bound_ms``: the product at fp32 accuracy on
    the tensor cores, by the faster of two splits: TF32 (an fp32 operand in
    hi + lo parts: 3 passes; int8 codes are exact, so 2) and bf16 (an fp32
    operand in 3 parts: 6 passes for fp32 x fp32, 3 for fp32 x int8 codes).
    ``bound_simt_ms``: the product in fp32 on the CUDA cores."""
    mac2 = 2.0 * b * k_q * n
    tf32 = (3 if dtype == "float32" else 2, PEAK_TF32_FLOPS, "TF32")
    bf16 = (6 if dtype == "float32" else 3, PEAK_BF16_FLOPS, "bf16")
    passes, peak, name = min(tf32, bf16, key=lambda split: split[0] / split[1])
    b_ms, b_by = bound(nb, passes * mac2, peak)
    simt_ms, _ = bound(nb, mac2)
    return dict(bound_ms=b_ms, bound_by=b_by, bound_peak=f"{passes}x{name} tensor cores",
                bound_simt_ms=simt_ms)


MMA_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void mma_loop(float* out, int iters) {
  float c[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  const uint32_t b0 = threadIdx.x * 7, b1 = threadIdx.x * 3;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int f = 0; f < 8; ++f)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+f"(c[f][0]), "+f"(c[f][1]), "+f"(c[f][2]), "+f"(c[f][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  float s = 0.f;
  for (int f = 0; f < 8; ++f) s += c[f][0] + c[f][1] + c[f][2] + c[f][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_loop_launch(int blocks, float* out, int iters) {
  mma_loop<<<blocks, 256>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def start_mma_probe_build(build):
    """Start nvcc on the mma.sync probe, beside the kernels' own builds."""
    out = os.path.join(HERE, "build", "probe")
    os.makedirs(out, exist_ok=True)
    src, lib = os.path.join(out, "mma_probe.cu"), os.path.join(out, "libmma_probe.so")
    with open(src, "w") as f:
        f.write(MMA_PROBE)
    proc = subprocess.Popen([build.find_nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def mma_tf32_tflops(lib_path, iters: int = 20000) -> dict:
    """TFLOP/s of back-to-back mma.sync.m16n8k8 TF32, eight independent
    accumulators a warp, at the top-k kernels' 8 warps an SM and at 32."""
    import torch

    lib = ctypes.CDLL(lib_path)
    lib.mma_loop_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rates = {}
    for per_sm in (1, 4):
        blocks = sms * per_sm
        out = torch.empty(blocks * 256, device="cuda")
        check(lib.mma_loop_launch(blocks, out.data_ptr(), 100) == 0, "mma.sync probe launch")
        ms = cuda_ms(lambda: lib.mma_loop_launch(blocks, out.data_ptr(), iters), 1)
        rates[f"{8 * per_sm}_warps_per_sm"] = blocks * 8 * iters * 8 * 2.0 * 16 * 8 * 8 / ms / 1e9
    return rates


def sass_count(lib_path, opcode: str) -> int:
    """Instructions of ``opcode`` in a built library's SASS (cuobjdump,
    beside nvcc)."""
    from repro_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                         check=True).stdout
    return len(re.findall(rf"\b{opcode}\b", out))


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

    from repro_torch.kernels.approx_topk.quant import as_payload

    e_q = torch.randn((b, k_q), generator=gen, device=dev)
    r = torch.randn((k_q, n), generator=gen, device=dev)
    anchors = torch.randint(0, n, (b, 100), generator=gen, device=dev, dtype=torch.int32)
    return e_q, {dtype: as_payload(r, dtype) for dtype in PAYLOADS}, anchors


def dense_fp32(pay):
    """The payload as one fp32 (k_q, N) tensor, as a library caller would
    form it: fp32 as is, bf16 cast, codes dequantized."""
    import torch

    from repro_torch.kernels.approx_topk.quant import QuantizedRanc, dequantize

    if isinstance(pay, QuantizedRanc):
        return dequantize(pay)
    return pay if pay.dtype == torch.float32 else pay.float()


def phase_approx_topk(shape, gen, dev, reps, earlier):
    import torch

    from repro_torch.kernels.approx_topk.ops import approx_topk_op, approx_topk_plain
    from repro_torch.kernels.approx_topk.ref import dense_scores
    from repro_torch.testing import topk_report

    b, k_q, n = shape
    e_q, payloads, anchors = make_inputs(b, k_q, n, gen, dev)
    rows, worst = [], dict.fromkeys(PAYLOADS, 0.0)
    for dtype, pay in payloads.items():
        scores = dense_scores(e_q, pay, anchors)
        for k in (20, 100):
            kv, ki = approx_topk_op(e_q, pay, anchors, k)
            pv, pi = approx_topk_plain(e_q, pay, anchors, k, tile=8192)
            torch.cuda.synchronize()
            rep = topk_report(ki, kv, pi, pv, scores)
            check(rep["ok"], f"approx_topk {dtype} k={k} disagrees with its plain version: {rep}")
            worst[dtype] = max(worst[dtype], rep["max_abs_err"])
            ms = cuda_ms(lambda: approx_topk_op(e_q, pay, anchors, k), reps)
            plain_ms = cuda_ms(lambda: approx_topk_plain(e_q, pay, anchors, k, tile=8192), 1)
            lib_ms = cuda_ms(lambda: torch.topk(torch.matmul(e_q, dense_fp32(pay)), k, dim=1),
                             reps)
            bounds = topk_bounds(dtype, nbytes(e_q, pay, anchors) + b * k * 8, b, k_q, n)
            rows.append(dict(payload=dtype, k=k, kernel_ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, **bounds, **rep,
                             earlier_design_ms_recorded=earlier.get(("approx_topk", dtype, k))))
        del scores
    rows += large_k_cases(e_q, payloads, anchors, gen, dev, reps, worst)
    # the router phase's searches: B = 16, 32 and 64 rows of the same fp32
    # inputs (fewer row groups, more column ranges to merge)
    for b_router in ROUTER_BUCKETS:
        for k in (20, 100):
            rows.append(topk_case(f"router_b{b_router}", e_q[:b_router], payloads["float32"],
                                  anchors[:b_router], k, reps, 8192, worst))
    # the sharded phase's per-rank searches: B = 128 rows (2 data shards)
    # over one item shard's slab, suppressed by the selected mask
    for dtype, pay, anc, mask in sharded_slabs(e_q, payloads, anchors):
        for k in (20, 100):
            rows.append(topk_case("sharded", e_q[:SHARD_ROWS], pay, None, k, reps, 8192,
                                  worst, mask=mask))
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
        dense = dense_scores(e2, pay, anc2, **kw)
        full = (dense > NEG_INF / 2).sum(1) >= 20        # rows with k valid items
        rep = topk_report(ki[full], kv[full], pi[full], pv[full], dense[full])
        check(rep["ok"], f"approx_topk {dtype} masked case disagrees: {rep}")
        under = underfilled_rows(dtype, e2, pay, noise, ki, kv, pi, pv, ~full, dense)
        check(torch.equal(ki[0].cpu(), torch.arange(20, dtype=torch.int32)),
              f"fully masked row must return ids 0..19, got {ki[0].tolist()}")
        ids1 = ki[1].cpu()
        check(len(set(ids1.tolist())) == 20, f"under-filled row repeats ids: {ids1.tolist()}")
        worst[dtype] = max(worst[dtype], rep["max_abs_err"])
        rows.append(dict(payload=dtype, k=20, case="noise+mask+anchors+n_valid", n=n2, **rep,
                         **under))
    return rows, worst


def topk_case(name, e_q, pay, anchors, k, reps, plain_tile, worst, mask=None) -> dict:
    """One fused-op case: the kernel against its plain version (ids equal, or
    within the tie-aware comparator), with kernel, plain, library
    (``torch.matmul`` + ``torch.topk``) and bound times; ``mask`` (B, N)
    suppresses as the sharded engine does."""
    import torch

    from repro_torch.kernels.approx_topk.ops import approx_topk_op, approx_topk_plain
    from repro_torch.kernels.approx_topk.quant import payload_dtype_of
    from repro_torch.kernels.approx_topk.ref import dense_scores
    from repro_torch.testing import topk_report

    dtype = payload_dtype_of(pay)
    b, k_q = e_q.shape
    n = pay.shape[1]
    kw = {} if mask is None else dict(mask=mask)
    kv, ki = approx_topk_op(e_q, pay, anchors, k, **kw)
    pv, pi = approx_topk_plain(e_q, pay, anchors, k, tile=plain_tile, **kw)
    torch.cuda.synchronize()
    rep = topk_report(ki, kv, pi, pv, dense_scores(e_q, pay, anchors, **kw))
    check(rep["ok"], f"approx_topk {name} {dtype} k={k} disagrees with its plain version: {rep}")
    worst[dtype] = max(worst[dtype], rep["max_abs_err"])
    ms = cuda_ms(lambda: approx_topk_op(e_q, pay, anchors, k, **kw), reps)
    plain_ms = cuda_ms(lambda: approx_topk_plain(e_q, pay, anchors, k, tile=plain_tile, **kw), 1)
    lib_ms = cuda_ms(lambda: torch.topk(torch.matmul(e_q, dense_fp32(pay)), k, dim=1), reps)
    bounds = topk_bounds(dtype, nbytes(e_q, pay, anchors, mask) + b * k * 8, b, k_q, n)
    # the sweep's and the merge's shares of one launch
    split = {r["name"].split("<")[0].split("::")[-1]: r["ms"]
             for r in profile_call(lambda: approx_topk_op(e_q, pay, anchors, k, **kw))["top"]}
    return dict(case=name, payload=dtype, b=b, k_q=k_q, n=n, k=k, kernel_ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, ids_equal=bool(torch.equal(ki, pi)),
                profile_ms=split, **bounds, **rep)


def large_k_cases(e_q, payloads, anchors, gen, dev, reps, worst) -> list:
    """The large-k instantiation (k in (256, 1024]): the serving shape at
    k = 800 and 1024 for fp32 and int8, and the dual-encoder first stage's
    shape (B = 100 queries x d = 16 over 10^6 items, k = 200 and 800: the
    rerank and hybrid shortlists), each against its plain version."""
    import torch

    rows = []
    for dtype in ("float32", "int8"):
        for k in (800, 1024):
            rows.append(topk_case("large_k", e_q, payloads[dtype], anchors, k, reps, 8192, worst))
    n = payloads["float32"].shape[1]
    q_emb = torch.randn((100, 16), generator=gen, device=dev)
    i_emb_t = torch.randn((16, n), generator=gen, device=dev)
    for k in (200, 800):
        rows.append(topk_case("dual_encoder", q_emb, i_emb_t, None, k, reps, 8192, worst))
    return rows


def underfilled_rows(dtype, e_q, pay, noise, ki, kv, pi, pv, under, dense):
    """Rows with fewer than k valid items select all of them: near-full
    selection, where ``topk_report``'s bar (1e-5 x max(|v|, 1)) is finer
    than fp32 summation at k_q = 500 for the small values such a row keeps
    (ROADMAP.md, queue 3).  There the kernel's values are held to float64
    (its worst error over every row's live entries is no larger than the
    plain version's), and position by position: a row's live entries are
    its valid items in float64 order (ties to the lower id) with
    non-increasing values, the plain version selects the same items, and
    the suppressed tail's ids equal the plain version's."""
    import torch

    from repro_torch.kernels.approx_topk.quant import QuantizedRanc, unpacked_codes

    coded = isinstance(pay, QuantizedRanc)
    exact = e_q.double() @ (unpacked_codes(pay) if coded else pay).double()
    if coded:
        exact *= pay.col_scales().double()[None, :]
    exact += noise.double()
    live = kv > NEG_INF / 2
    check(torch.equal(live, pv > NEG_INF / 2), f"approx_topk {dtype}: live entries differ")

    def err(v, i):
        return (v.double() - exact.gather(1, i.long())).abs()[live].max().item()

    err_kernel, err_plain = err(kv, ki), err(pv, pi)
    check(err_kernel <= err_plain, f"approx_topk {dtype} masked case: worst error against "
                                   f"float64 {err_kernel} above the plain version's {err_plain}")
    for r in torch.nonzero(under).flatten().tolist():
        n_live = int(live[r].sum())
        valid = torch.nonzero(dense[r] > NEG_INF / 2).flatten()    # ascending ids
        order = torch.sort(-exact[r, valid], stable=True).indices
        want = valid[order].to(ki.dtype).cpu()
        row = kv[r, :n_live]
        same = (n_live == valid.numel() and torch.equal(ki[r, :n_live].cpu(), want)
                and bool((row[1:] <= row[:-1]).all())
                and sorted(pi[r, :n_live].tolist()) == want.sort().values.tolist()
                and torch.equal(ki[r, n_live:], pi[r, n_live:]))
        check(same, f"approx_topk {dtype}: under-filled row {r} ids {ki[r].tolist()} "
                    f"values {kv[r, :n_live].tolist()}: float64 order {want.tolist()}, "
                    f"plain {pi[r].tolist()}")
    del exact
    return dict(underfilled_rows=int(under.sum()), f64_err_kernel=err_kernel,
                f64_err_plain=err_plain)


def persistent_case(e_q, pay, anchors, prov_mask, reps, worst, mask=None) -> dict:
    """One persistent-round case (sample k = 20 with ``anchors`` suppressed,
    or the (B, N) ``mask`` where one is given, as the sharded engine
    suppresses; provisional k = 100 under ``prov_mask``): bitwise equal to
    two approx_topk calls, each list against the plain version, with
    kernel, plain, library and bound times."""
    import torch

    from repro_torch.kernels.approx_topk.ops import approx_topk_op
    from repro_torch.kernels.approx_topk.persistent import (
        persistent_round_op, persistent_round_plain,
    )
    from repro_torch.kernels.approx_topk.quant import payload_dtype_of
    from repro_torch.kernels.approx_topk.ref import dense_scores
    from repro_torch.testing import topk_report

    dtype = payload_dtype_of(pay)
    b, k_q = e_q.shape
    n = pay.shape[1]
    kw = dict(k_sample=20, k_prov=100, anchors=anchors, mask=mask, prov_mask=prov_mask)
    (sv, si), (pv, pi) = persistent_round_op(e_q, pay, **kw)
    (qv, qi), (rv, ri) = persistent_round_plain(e_q, pay, tile=8192, **kw)
    av, ai = approx_topk_op(e_q, pay, anchors, 20, mask=mask)
    bv, bi = approx_topk_op(e_q, pay, None, 100, mask=prov_mask)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(x, y) for x, y in ((sv, av), (si, ai), (pv, bv), (pi, bi)))
    check(bitwise, f"persistent_round {dtype} B={b} is not bitwise equal to two approx_topk calls")
    lists = {"sample": ((si, sv), (qi, qv), dict(anchors=anchors, mask=mask)),
             "prov": ((pi, pv), (ri, rv), dict(mask=prov_mask))}
    for name, (x, y, sup) in lists.items():
        rep = topk_report(x[0], x[1], y[0], y[1], dense_scores(e_q, pay, **sup))
        check(rep["ok"], f"persistent_round {dtype} B={b} {name} disagrees with its plain "
                         f"version: {rep}")
        worst[dtype] = max(worst[dtype], rep["max_abs_err"])
    ms = cuda_ms(lambda: persistent_round_op(e_q, pay, **kw), reps)
    plain_ms = cuda_ms(lambda: persistent_round_plain(e_q, pay, tile=8192, **kw), 1)

    def library():
        s = torch.matmul(e_q, dense_fp32(pay))
        torch.topk(s, 20, dim=1)
        torch.topk(s.masked_fill(prov_mask, -1e30), 100, dim=1)

    lib_ms = cuda_ms(library, reps)
    bounds = topk_bounds(dtype, nbytes(e_q, pay, anchors, mask, prov_mask) + b * 120 * 8,
                         b, k_q, n)
    return dict(payload=dtype, b=b, k_sample=20, k_prov=100, kernel_ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, **bounds, bitwise_vs_staged=bitwise)


def phase_persistent(shape, gen, dev, reps, earlier):
    import torch

    b, k_q, n = shape
    e_q, payloads, anchors = make_inputs(b, k_q, n, gen, dev)
    prov_mask = torch.rand((b, n), generator=gen, device=dev) < 0.1
    rows, worst = [], dict.fromkeys(PAYLOADS, 0.0)
    for dtype, pay in payloads.items():
        row = persistent_case(e_q, pay, anchors, prov_mask, reps, worst)
        rows.append(dict(row, earlier_design_ms_recorded=earlier.get(
            ("persistent_round", dtype, 20))))
    # the router phase's searches: B = 16, 32 and 64 rows of the fp32 inputs
    for b_router in ROUTER_BUCKETS:
        rows.append(dict(persistent_case(e_q[:b_router], payloads["float32"],
                                         anchors[:b_router], prov_mask[:b_router], reps, worst),
                         case=f"router_b{b_router}"))
    # the sharded phase's per-rank sweeps: B = 128 over one item shard's
    # slab, suppressed by the selected mask as the sharded engine does
    for dtype, pay, _, mask in sharded_slabs(e_q, payloads, anchors):
        rows.append(dict(persistent_case(e_q[:SHARD_ROWS], pay, None,
                                         prov_mask[:SHARD_ROWS, :pay.shape[1]], reps, worst,
                                         mask=mask),
                         case="sharded"))
    return rows, worst


def sharded_slabs(e_q, payloads, anchors):
    """(payload, one item shard's slab of it, the slab's anchors, the
    selected mask those anchors make) at the sharded phase's shapes: the
    fp32 and int8 payloads cut to the first of ``SHARDED_MESH[1]`` slabs of a
    capacity aligned as ``AnchorIndex.shard`` aligns it."""
    import torch

    from repro_torch.kernels.approx_topk.quant import QuantizedRanc

    b, n = SHARD_ROWS, payloads["float32"].shape[1]
    if n < 1_000_000:       # --quick: the kernel phases' small shape has no such slab
        return
    for dtype in ("float32", "int8"):
        pay = payloads[dtype]
        grain = 512 if dtype == "int8" else 128          # lcm(tile, NOISE_BLOCK)
        unit = SHARDED_MESH[1] * grain
        local = -(-n // unit) * unit // SHARDED_MESH[1]
        if dtype == "int8":
            slab = QuantizedRanc(pay.codes[:, :local].contiguous(), pay.scales[:local // 512],
                                 512, "int8")
        else:
            slab = pay[:, :local].contiguous()
        anc = anchors[:b].clone()
        mask = torch.zeros((b, local), dtype=torch.bool, device=anc.device)
        mask.scatter_(1, anc.long().clamp(0, local - 1), True)
        yield dtype, slab, anc, mask
        del slab, mask


def profile_call(fn, sums=()) -> dict:
    """One call under torch.profiler: device time by kernel name, the
    device-busy share of the call's wall time (the union of the kernels'
    and copies' intervals: work on several streams overlaps, so their
    summed time may exceed the wall), the kernels launched; ``sums``: name
    fragments whose kernels' device ms are added up (``ms_by_name``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    by_name = {part: sum(r[0] for r in rows if part in r[1]) / 1e3 for part in sums}
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA and ev.name not in CUPTI_BOOKKEEPING)
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    busy_ms = busy_us / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms if wall_ms else None,
            "device_ms_summed": sum(r[0] for r in rows) / 1e3,
            "device_launches": sum(r[2] for r in rows),
            "top": [{"name": k[:90], "ms": us / 1e3, "calls": c} for us, k, c in rows[:12]],
            **({"ms_by_name": by_name} if sums else {})}


def phase_serve(dev, ce, index, build_s):
    """The synthetic serve drives over the serve CLI's domain (``ce``,
    ``index``); returns (result, {kernel: {payload: launches}})."""
    import torch

    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core import prng, sampling
    from repro_torch.core.engine import AdaCURRetriever
    from repro_torch.core.scorer import SyntheticScorer
    from repro_torch.eval.metrics import exact_topk

    n_items = index.n_items
    served_q = torch.arange(500, 600, device=dev)
    _, gt = exact_topk(ce.full_matrix(served_q), 100)
    gt = gt.cpu()
    noise_ms = cuda_ms(lambda: sampling.blocked_gumbel(prng.PRNGKey(1), 256, n_items, device=dev), 2)
    results = []
    launches = {name: dict.fromkeys(PAYLOADS, 0) for name in ("approx_topk", "persistent_round")}
    fp32_bytes = index.payload_nbytes
    for payload in PAYLOADS:
        served_index = index.quantize(payload)
        for round_kernel in ("staged", "persistent"):
            results.append(serve_config(ce, served_index, payload, round_kernel, gt, launches,
                                        fp32_bytes, n_items))
        del served_index
    cfg = AdaCURConfig(k_anchor=100, n_rounds=5, budget_ce=200, strategy="topk",
                       k_retrieve=100, loop_mode="fori", use_fused_topk=True)
    retriever = AdaCURRetriever.from_index(index, SyntheticScorer(ce), cfg)
    qids = torch.arange(500, 756, device=dev) % 600
    profiled = profile_call(lambda: retriever.search(qids, prng.PRNGKey(5)))
    return dict(index_build_s=build_s, round0_noise_ms_B256=noise_ms, n_items=n_items,
                configs=results, profile_fp32_staged_B256=profiled), launches


def serve_config(ce, index, payload, round_kernel, gt, launches, fp32_bytes, n_items):
    """600 requests through AdaCURService(max_batch=256) over ``index``;
    adds the kernels' launches to ``launches[kernel][payload]``."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core.engine import AdaCURRetriever, ce_call_plan, engine_slab_bytes
    from repro_torch.core.scorer import SyntheticScorer
    from repro_torch.eval.metrics import topk_recall
    from repro_torch.launch.serve import AdaCURService, drive

    label = f"{payload} {round_kernel}"
    cfg = AdaCURConfig(k_anchor=100, n_rounds=5, budget_ce=200, strategy="topk",
                       k_retrieve=100, loop_mode="fori", use_fused_topk=True,
                       payload_dtype=payload, round_kernel=round_kernel)
    scorer = SyntheticScorer(ce)
    svc = AdaCURService(retriever=AdaCURRetriever.from_index(index, scorer, cfg),
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
    expect.update(flash_attention=0, embedding_bag=0, embedding_bag_backward=0)
    check(counts == expect, f"serve {label}: launches {counts}, expected {expect}")
    for name in launches:
        launches[name][payload] += counts[name]
    retrieved = torch.as_tensor(np.stack([r.item_ids for r in served]))
    rows = gt[[r.query_id - 500 for r in served]]
    recall = {f"recall@{k}": topk_recall(retrieved, rows, k) for k in (1, 10, 100)}
    for r in served:
        check(r.item_ids.shape == (100,) and np.isfinite(r.scores).all()
              and ((r.item_ids >= 0) & (r.item_ids < n_items)).all(),
              f"serve {label}: malformed response for query {r.query_id}")
    secs = [bl["seconds"] for bl in svc.batch_log]
    return dict(
        config=label, requests=len(served), searches=n_search,
        buckets=[bl["bucket"] for bl in svc.batch_log],
        batch_p50_ms=float(np.percentile(secs, 50) * 1e3),
        batch_p99_ms=float(np.percentile(secs, 99) * 1e3),
        per_search_ms=float(np.mean(secs) * 1e3),
        launches=counts, measured_ce_per_request=served[0].measured_ce_calls,
        ce_plan=plan, errors=len(errors), payload_bytes=index.payload_nbytes,
        fp32_payload_bytes=fp32_bytes,
        engine_slab_bytes=engine_slab_bytes(cfg, 256, n_items, index.k_q, payload=index.r_anc),
        **recall,
    )


def phase_retrievers(dev, ce, index):
    """The paper's budget-matched comparison (``eval.harness.quality_matrix``)
    at the serve CLI's domain: budget 200 in 5 rounds (k_anchor 100),
    k_retrieve 100, fused, fp32, DE and BM25 shortlists of 800 (BM25 over
    the domain's ``lexical_signatures``, seed 3), the tabulated 600 x 10^6
    fp32 matrix on the card.  Gates: every method's measured CE equals its
    plan, every method launches approx_topk, and the fused round body
    creates no (B, N) float; recall is printed, not gated.  Then the two
    hybrids in subset mode (the union of the 100 shortlists gathered into a
    sub-payload): measured CE = plan, and top-k ids and scores bitwise equal
    to the full-corpus search masked to the union (the reference's
    contract), with µs a query beside mask mode's."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import prng
    from repro_torch.core.candidates import (BM25Candidates, DualEncoderCandidates,
                                             HybridRetriever, candidate_eligibility,
                                             union_candidates)
    from repro_torch.core.engine import make_engine, round_body_bn_intermediates
    from repro_torch.core.scorer import TabulatedScorer
    from repro_torch.data.synthetic import lexical_signatures
    from repro_torch.eval.harness import matrix_config, quality_matrix
    from repro_torch.eval.metrics import evaluate_result

    t0 = time.perf_counter()
    matrix = ce.full_matrix(torch.arange(600, device=dev))
    torch.cuda.synchronize()
    matrix_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokens = (lexical_signatures(ce.i_emb, seed=3), lexical_signatures(ce.q_emb, seed=3))
    tokens_s = time.perf_counter() - t0
    test_q = torch.arange(500, 600, device=dev)
    kernels.reset_launches()
    reports = quality_matrix(ce, index, test_q, matrix, budget=200, n_rounds=5,
                             ks=(1, 10, 100), shortlist_k=800, use_fused_topk=True,
                             corpus_tokens=tokens[0], query_tokens=tokens[1])
    torch.cuda.synchronize()
    # the main path's launches: the comparison's and the subset searches',
    # not the checks' masked searches and shortlists
    launches = kernels.launch_counts()
    cfg = matrix_config(200, 5, (1, 10, 100), use_fused_topk=True)
    key, b = prng.PRNGKey(0), test_q.shape[0]
    exact = matrix[test_q]
    mask_us = {rep.method: rep.wall_us_per_query for rep in reports}
    subset = []
    for name, gen in (("hybrid_de", DualEncoderCandidates(ce.q_emb, ce.i_emb, n_valid=index.n_items)),
                      ("hybrid_bm25", BM25Candidates(*tokens, n_valid=index.n_items, device=dev))):
        scorer = TabulatedScorer(matrix)
        ret = HybridRetriever(score_fn=scorer, generator=gen, cfg=cfg, index=index,
                              shortlist_k=800, mode="subset")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = ret.search(test_q, key)
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) / b * 1e6
        launches = {k: launches[k] + c for k, c in kernels.launch_counts().items()}
        cand = gen(test_q, 800)
        union = candidate_eligibility(cand, index.capacity, per_query=False)
        masked = make_engine(TabulatedScorer(matrix), cfg)(index.r_anc, test_q, key,
                                                          eligible=union,
                                                          item_ids=index.item_ids)
        n_sub = int(union_candidates(cand, ret._capacity(b), index.capacity)[2])
        bitwise = bool(torch.equal(res.topk_idx, masked.topk_idx)
                       and torch.equal(res.topk_scores, masked.topk_scores))
        check(bitwise, f"retrievers {name} subset: top-k differs from the union-masked search")
        check(scorer.stats.ce_calls == ret.ce_call_plan() * b,
              f"retrievers {name} subset: measured CE {scorer.stats.ce_calls} != plan "
              f"{ret.ce_call_plan()} x {b}")
        subset.append(dict(method=name, union_columns=n_sub, subset_capacity=ret._capacity(b),
                           measured_ce=scorer.stats.ce_calls // b, planned_ce=ret.ce_call_plan(),
                           bitwise_equal_to_union_mask=bitwise, subset_us_per_query=us,
                           mask_us_per_query=mask_us[name],
                           topk_recall=evaluate_result(name, res, exact,
                                                       ks=(1, 10, 100)).recall))
    bn = round_body_bn_intermediates(TabulatedScorer(matrix), index.r_anc, test_q, cfg)
    check(bn == 0, f"retrievers: the fused round body creates {bn} (B, N) float tensors")
    rows = []
    for rep in reports:
        check(rep.budget_matched, f"retrievers {rep.method}: measured CE {rep.measured_ce} "
                                  f"!= plan {rep.planned_ce}")
        check(rep.launches["approx_topk"] > 0,
              f"retrievers {rep.method}: approx_topk never launched ({rep.launches})")
        # ADACUR and the hybrids run the adaptive round body; ANNCUR and
        # rerank search one retriever-seeded round and have none
        rounds = rep.method in ("adacur", "hybrid_de", "hybrid_bm25")
        rows.append(dict(**rep.to_json(), round_body_bn_intermediates=bn if rounds else None))
    del matrix
    torch.cuda.empty_cache()
    return dict(n_items=index.n_items, test_queries=100, budget=200, n_rounds=5,
                shortlist_k=800, matrix_gb=600 * index.n_items * 4 / 1e9, matrix_s=matrix_s,
                lexical_signatures_s=tokens_s, launches=launches, methods=rows,
                subset_mode=subset), launches


def phase_anytime(dev, ce, index):
    """256 requests through AdaCURService(max_batch=256) over an anytime
    retriever at N = 10^6, twice: every request's deadline already past
    (one round, degraded, CE = ce_call_plan(cfg, 1) a request) and no
    deadline (every round, not degraded)."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core.engine import AdaCURRetriever, ce_call_plan
    from repro_torch.core.scorer import SyntheticScorer
    from repro_torch.launch.serve import AdaCURService, RetrievalRequest

    cfg = AdaCURConfig(k_anchor=100, n_rounds=5, budget_ce=200, strategy="topk",
                       k_retrieve=100, loop_mode="fori", use_fused_topk=True)
    svc = AdaCURService(retriever=AdaCURRetriever.from_index(
        index, SyntheticScorer(ce), cfg, anytime=True), max_batch=256, max_wait_s=600.0)
    out = {}
    for name, rounds, plan in (("expired", 1, ce_call_plan(cfg, 1)),
                               ("none", cfg.n_rounds, ce_call_plan(cfg))):
        kernels.reset_launches()
        past = time.monotonic() - 1.0
        served = []
        for i in range(256):
            served += svc.submit(RetrievalRequest(
                query_id=500 + i % 100, deadline_t=past if name == "expired" else None)) or []
        torch.cuda.synchronize()
        check(len(served) == 256 and all(r.status == "ok" for r in served),
              f"anytime {name}: {len(served)} responses, errors "
              f"{[r.error for r in served if r.status != 'ok'][:1]}")
        degraded = name == "expired"
        for r in served:
            check(r.rounds_completed == rounds and r.degraded == degraded
                  and r.measured_ce_calls == plan,
                  f"anytime {name}: query {r.query_id} rounds {r.rounds_completed}, degraded "
                  f"{r.degraded}, CE {r.measured_ce_calls} (want {rounds}, {degraded}, {plan})")

        def seen(field):   # the distinct values the 256 responses carry
            return sorted({getattr(r, field) for r in served})

        out[name] = dict(rounds_completed=seen("rounds_completed"), degraded=seen("degraded"),
                         measured_ce_per_request=seen("measured_ce_calls"), ce_plan=plan, search_ms=svc.batch_log[-1]["seconds"] * 1e3,
                         launches=kernels.launch_counts())
    return out


class Preempted(Exception):
    """The interruption of the index_lifecycle phase's build."""


def same_payload(a, b) -> bool:
    """Two payloads' bytes (and, coded, their tile layout) equal."""
    import torch

    from repro_torch.kernels.approx_topk.quant import QuantizedRanc

    if isinstance(a, QuantizedRanc) != isinstance(b, QuantizedRanc):
        return False
    if isinstance(a, QuantizedRanc):
        return ((a.tile, a.code_dtype, a.n_cols) == (b.tile, b.code_dtype, b.n_cols)
                and torch.equal(a.codes.cpu().view(torch.uint8), b.codes.cpu().view(torch.uint8))
                and torch.equal(a.scales.cpu(), b.scales.cpu()))
    return a.dtype == b.dtype and torch.equal(a.cpu().view(torch.uint8), b.cpu().view(torch.uint8))


def same_index(a, b) -> bool:
    import torch

    return (same_payload(a.r_anc, b.r_anc)
            and torch.equal(a.item_ids.cpu(), b.item_ids.cpu())
            and int(a.n_valid) == int(b.n_valid)
            and torch.equal(a.anchor_query_ids.cpu(), b.anchor_query_ids.cpu()))


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def lifecycle_search(ce, index, payload, round_kernel="persistent"):
    """One B = 256 engine search over ``index`` (queries 500..755 mod 600,
    key 5) -> (result, measured CE calls, plan x B)."""
    import torch

    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core import prng
    from repro_torch.core.engine import AdaCURRetriever, ce_call_plan
    from repro_torch.core.scorer import SyntheticScorer

    cfg = AdaCURConfig(k_anchor=100, n_rounds=5, budget_ce=200, strategy="topk",
                       k_retrieve=100, loop_mode="fori", use_fused_topk=True,
                       payload_dtype=payload, round_kernel=round_kernel)
    scorer = SyntheticScorer(ce)
    qids = torch.arange(500, 756, device=ce.device) % 600
    res = AdaCURRetriever.from_index(index, scorer, cfg).search(qids, prng.PRNGKey(5))
    torch.cuda.synchronize()
    return res, scorer.stats.ce_calls, ce_call_plan(cfg) * 256


def phase_index_lifecycle(dev, ce, index):
    """The AnchorIndex lifecycle at the serve domain's full size (k_q = 500,
    N = 10^6): (a) a resumable build interrupted after 2 of its 4 blocks of
    128 rows, resumed (scores only the 2 missing blocks, R_anc bit-equal to
    build_domain's); (b) save and load of every payload in a temp directory
    (bytes on disk, seconds, GB/s; ``topk`` at B = 256, k = 100 and a
    B = 256 persistent engine search bit-equal after the load); (c)
    ``with_capacity(2^20)``, ``remove_items`` of every 100th id and
    ``add_items`` of them back, each held, for fp32, against ``from_r_anc``
    over the same columns in the same order (payload bytes, item ids,
    ``topk`` and the engine's ids, values and measured CE = plan) and, for
    the coded payloads, against the same mutation on the CPU (bytes), with
    a search over the mutated index (n_valid < capacity, CE = plan, no
    removed id served); (d) ``swap_index`` with 64 requests queued, answered
    under the old index, none after it serving a removed id.  Returns
    (result, {kernel: {payload: launches}}), the launches of the loaded and
    mutated indexes' searches and the service's, not of the references
    they are held against."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core.engine import AdaCURRetriever
    from repro_torch.core.index import AnchorIndex, build_r_anc, clear_build_checkpoints
    from repro_torch.core.scorer import SyntheticScorer
    from repro_torch.launch.serve import AdaCURService, RetrievalRequest

    n, k_q = index.n_items, index.k_q
    launches = {name: dict.fromkeys(PAYLOADS, 0) for name in ("approx_topk", "persistent_round")}

    def count(payload):
        for name, c in kernels.launch_counts().items():
            if name in launches:
                launches[name][payload] += c
        kernels.reset_launches()

    tmp = tempfile.mkdtemp(prefix="adacur_index_")
    try:
        # (a) resumable build
        ck = os.path.join(tmp, "build")
        calls = {"scored": 0, "stop_at": 2}

        def scorer(q, i):
            if calls["scored"] == calls["stop_at"]:
                raise Preempted()
            calls["scored"] += 1
            return ce.score_block(q, i)

        q_ids, i_ids = torch.arange(k_q, device=dev), torch.arange(n, device=dev)
        try:
            build_r_anc(scorer, q_ids, i_ids, block_rows=128, checkpoint_dir=ck)
            check(False, "index_lifecycle: the interrupted build ran to its end")
        except Preempted:
            pass
        calls.update(scored=0, stop_at=None)
        t0 = time.perf_counter()
        resumed = build_r_anc(scorer, q_ids, i_ids, block_rows=128, checkpoint_dir=ck)
        torch.cuda.synchronize()
        build = dict(blocks=4, block_rows=128, resumed_blocks_scored=calls["scored"],
                     resume_s=time.perf_counter() - t0,
                     bit_equal_to_build_domain=bool(torch.equal(resumed, index.r_anc)))
        check(calls["scored"] == 2, f"index_lifecycle: the resumed build scored "
                                    f"{calls['scored']} blocks, not the 2 missing")
        check(build["bit_equal_to_build_domain"],
              "index_lifecycle: the resumed R_anc differs from build_domain's")
        del resumed
        clear_build_checkpoints(ck)

        # (b) save and load, every payload
        gen = torch.Generator(device=dev)
        gen.manual_seed(18)
        e_q = torch.randn((256, k_q), generator=gen, device=dev)
        saved = []
        kernels.reset_launches()
        for payload in PAYLOADS:
            idx = index.quantize(payload)
            path = os.path.join(tmp, payload)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            idx.save(path)
            save_s = time.perf_counter() - t0
            disk = dir_bytes(path)
            t0 = time.perf_counter()
            loaded = AnchorIndex.load(path, device=dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            with open(os.path.join(path, "index_meta.json")) as f:
                version = json.load(f)["format_version"]
            check(same_index(idx, loaded), f"index_lifecycle: {payload} loads other leaves")
            av, ai = idx.topk(e_q, 100)
            ra, _, _ = lifecycle_search(ce, idx, payload)
            kernels.reset_launches()            # counted: the loaded index only
            bv, bi = loaded.topk(e_q, 100)
            rb, measured, plan = lifecycle_search(ce, loaded, payload)
            count(payload)
            check(torch.equal(av, bv) and torch.equal(ai, bi),
                  f"index_lifecycle: {payload} topk differs after the load")
            check(torch.equal(ra.topk_idx, rb.topk_idx) and measured == plan,
                  f"index_lifecycle: {payload} engine search differs after the load "
                  f"(CE {measured} vs plan {plan})")
            saved.append(dict(payload=payload, format_version=version, disk_bytes=disk,
                              payload_bytes=idx.payload_nbytes, save_s=save_s, load_s=load_s,
                              save_gb_s=disk / save_s / 1e9, load_gb_s=disk / load_s / 1e9))
            shutil.rmtree(path)
            del idx, loaded

        # (c) mutation: capacity to the next power of two above N + 1% (2^20)
        cap = 1 << (n + n // 100).bit_length()
        rm_ids = torch.arange(0, n, 100, device=dev, dtype=torch.int32)
        rm_host = rm_ids.cpu().numpy()
        cols = index.r_anc[:, rm_ids.long()]
        keep = torch.ones(n, dtype=torch.bool, device=dev)
        keep[rm_ids.long()] = False
        surv = torch.nonzero(keep).flatten().to(torch.int32)
        order = torch.cat([surv, rm_ids])
        mutated, fp32_steps = [], {}
        for payload in PAYLOADS:
            base = index.quantize(payload)
            steps, secs = [], {}
            for name, fn in (("with_capacity", lambda x: x.with_capacity(cap)),
                             ("remove_items", lambda x: x.remove_items(rm_ids)),
                             ("add_items", lambda x: x.add_items(rm_ids, cols=cols))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                base = fn(base)
                torch.cuda.synchronize()
                secs[name] = time.perf_counter() - t0
                steps.append((name, base))
            row = dict(payload=payload, seconds=secs, n_valid=[int(x.n_valid) for _, x in steps])
            if payload == "float32":
                fresh = [AnchorIndex.from_r_anc(index.r_anc[:, c.long()], item_ids=c,
                                                capacity=cap)
                         for c in (i_ids.to(torch.int32), surv, order)]
                for (name, got), want in zip(steps, fresh):
                    check(same_index(got, want),
                          f"index_lifecycle: fp32 {name} differs from a rebuild")
                    bv, bi = want.topk(e_q, 100)
                    rb, mb, _ = lifecycle_search(ce, want, payload, "staged")
                    kernels.reset_launches()        # counted: the mutated index only
                    av, ai = got.topk(e_q, 100)
                    ra, ma, plan = lifecycle_search(ce, got, payload, "staged")
                    count(payload)
                    check(torch.equal(av, bv) and torch.equal(ai, bi)
                          and torch.equal(ra.topk_idx, rb.topk_idx)
                          and torch.equal(ra.topk_scores, rb.topk_scores)
                          and ma == mb == plan,
                          f"index_lifecycle: fp32 {name} searches differ from a rebuild's "
                          f"(CE {ma}, {mb}, plan {plan})")
                fp32_steps = dict(steps)
                row["held_against"] = "from_r_anc rebuild"
                del fresh
            else:
                cpu = index.quantize(payload).to("cpu")
                for name, got in steps:
                    cpu = {"with_capacity": lambda x: x.with_capacity(cap),
                           "remove_items": lambda x: x.remove_items(rm_ids.cpu()),
                           "add_items": lambda x: x.add_items(rm_ids.cpu(), cols=cols.cpu()),
                           }[name](cpu)
                    check(same_index(got, cpu),
                          f"index_lifecycle: {payload} {name} bytes differ from the CPU's")
                shrunk = dict(steps)["remove_items"]
                kernels.reset_launches()
                res, measured, plan = lifecycle_search(ce, shrunk, payload)
                count(payload)
                served = shrunk.gather_item_ids(res.topk_idx)
                check(measured == plan and not np.isin(served.cpu().numpy(), rm_host).any(),
                      f"index_lifecycle: {payload} search over the shrunk index "
                      f"(CE {measured}, plan {plan}) or served a removed id")
                row["held_against"] = "the same mutation on the CPU"
                del cpu
            mutated.append(row)
            del steps, base

        # (d) swap_index with 64 requests queued
        cfg = AdaCURConfig(k_anchor=100, n_rounds=5, budget_ce=200, strategy="topk",
                           k_retrieve=100, loop_mode="fori", use_fused_topk=True)
        svc = AdaCURService(retriever=AdaCURRetriever.from_index(
            fp32_steps["with_capacity"], SyntheticScorer(ce), cfg), max_batch=256,
            max_wait_s=1e9)
        kernels.reset_launches()
        for i in range(64):
            check(svc.submit(RetrievalRequest(query_id=500 + i)) is None,
                  "index_lifecycle: a batch fired before the swap")
        drained = svc.swap_index(fp32_steps["remove_items"])
        torch.cuda.synchronize()
        old_ids = np.stack([r.item_ids for r in drained])
        for i in range(64):
            svc.submit(RetrievalRequest(query_id=500 + i))
        after = svc.flush()
        new_ids = np.stack([r.item_ids for r in after])
        swap = dict(queued=64, drained=len(drained),
                    drained_removed_ids=int(np.isin(old_ids, rm_host).sum()),
                    after_removed_ids=int(np.isin(new_ids, rm_host).sum()),
                    errors=sum(r.status != "ok" for r in drained + after))
        check(len(drained) == 64 and swap["errors"] == 0 and swap["drained_removed_ids"] > 0
              and swap["after_removed_ids"] == 0,
              f"index_lifecycle: swap_index {swap}")
        count("float32")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(n_items=n, k_q=k_q, capacity=cap, removed=int(rm_ids.numel()), build=build,
                save_load=saved, mutation=mutated, swap=swap), launches


ROUTER_N_REQUESTS = 256
# capacity: closed loops of 2,048 requests (32 full batches, ~5 s on the
# card), each configuration run CAPACITY_REPEATS times interleaved, so the
# spread across runs shows beside the 1-vs-2-replica ratio
CAPACITY_REQUESTS = 2048
CAPACITY_REPEATS = 3
SWAP_OFFSET = 10 ** 7          # the swapped index's external ids: item_ids + 10^7
# the watchdog of the scenarios that do not test it: a threshold far above
# the spread of healthy batch times across buckets 16-64
LAX_WATCHDOG = dict(watchdog_threshold=50.0, watchdog_patience=3)
ROUTER_WATCHDOG_S = 300        # a router phase still running then is deadlocked


def router_cfg(round_kernel="staged"):
    from repro_torch.configs.base import AdaCURConfig

    return AdaCURConfig(k_anchor=100, n_rounds=5, budget_ce=200, strategy="topk",
                        loop_mode="fori", use_fused_topk=True, round_kernel=round_kernel)


def router_services(ce, index, cfg, n, plan=None, buckets=ROUTER_BUCKETS, deterministic=False):
    """``n`` AdaCURServices over the one shared ``index``, each with its own
    anytime retriever and its own scorer over the domain (a FaultyScorer
    around a SyntheticScorer that answers both id namespaces of the swap)."""
    from repro_torch.core.engine import AdaCURRetriever
    from repro_torch.core.scorer import SyntheticScorer
    from repro_torch.launch.faults import FaultyScorer
    from repro_torch.launch.serve import AdaCURService

    class NamespaceScorer(SyntheticScorer):
        def __call__(self, query, item_idx):
            return super().__call__(query, item_idx % SWAP_OFFSET)

    return [AdaCURService(retriever=AdaCURRetriever.from_index(
                index, FaultyScorer(NamespaceScorer(ce), plan, replica=rid), cfg, anytime=True),
            max_batch=buckets[-1], max_wait_s=60.0, batch_buckets=list(buckets),
            deterministic=deterministic)
            for rid in range(n)]


def drive_router(router, qids, rate=None, seed=0, deadline_s=None):
    """Submit ``qids`` (all at once, or Poisson arrivals at ``rate`` a
    second from a seeded generator), then wait for every outcome; returns
    (tickets, outcomes, wall seconds, whether the swap had fired by each
    submit's return)."""
    import numpy as np

    gaps = (np.random.default_rng(seed).exponential(1.0 / rate, len(qids))
            if rate else np.zeros(len(qids)))
    arrive = np.cumsum(gaps)
    tickets, swapped = [], []
    t0 = time.monotonic()
    for q, at in zip(qids, arrive):
        wait = t0 + at - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        tickets.append(router.submit(int(q), deadline_s=deadline_s))
        swapped.append(router.stats["swaps"] > 0)
    outs = [router.result(t, timeout=300.0) for t in tickets]
    wall = time.monotonic() - t0
    check(router.drain(60.0), "router: tickets still live after every outcome was read")
    return tickets, outs, wall, swapped


def router_gates(name, router, cfg, tickets, outs, wall, launches) -> dict:
    """The gates every scenario shares: one terminal outcome per submitted
    request, each answering its own ticket; ``router.stats`` adds up; every
    batch's measured CE = ce_call_plan(cfg, rounds) x bucket; approx_topk
    launched.  Returns the scenario's row."""
    import numpy as np

    from repro_torch.core.engine import ce_call_plan

    n = len(tickets)
    check(all(o is not None for o in outs), f"router {name}: {sum(o is None for o in outs)} "
                                            "requests without a terminal outcome")
    for tk, o in zip(tickets, outs):
        check(o.seq == tk.seq and o.query_id == tk.query_id
              and (o.response is None or o.response.query_id == tk.query_id),
              f"router {name}: ticket {tk.seq} (query {tk.query_id}) answered by {o}")
        check(o.status in ("ok", "error", "rejected"), f"router {name}: status {o.status}")
    by = {s: sum(o.status == s for o in outs) for s in ("ok", "error", "rejected")}
    degraded = sum(o.degraded for o in outs)
    st = router.stats
    check(st["submitted"] == n and st["admitted"] + st["rejected"] == n
          and st["ok"] == by["ok"] and st["errors"] == by["error"]
          and st["rejected"] == by["rejected"] and st["degraded"] == degraded,
          f"router {name}: stats {st} against outcomes {by}, degraded {degraded}")
    batches = [bl for rep in router.replicas for bl in rep.service.batch_log]
    for bl in batches:
        check(bl["ce_calls"] == ce_call_plan(cfg, bl["rounds"]) * bl["bucket"],
              f"router {name}: batch CE {bl['ce_calls']} != plan {ce_call_plan(cfg, bl['rounds'])}"
              f" x {bl['bucket']} ({bl['rounds']} rounds)")
    check(launches["approx_topk"] > 0, f"router {name}: approx_topk never launched")
    lat = [o.latency_s * 1e3 for o in outs if o.status == "ok"]
    hedged = [o.latency_s * 1e3 for o in outs if o.status == "ok" and o.hedged]
    by_bucket = {}
    for bl in batches:
        by_bucket.setdefault(bl["bucket"], []).append(bl["seconds"] * 1e3)
    return dict(requests=n, wall_s=wall, qps=n / wall, ok=by["ok"], degraded=degraded,
                errors=by["error"], rejected=by["rejected"],
                p50_ms=float(np.percentile(lat, 50)) if lat else None,
                p99_ms=float(np.percentile(lat, 99)) if lat else None,
                hedges=st["hedges"], retries=st["retries"], quarantines=st["quarantines"],
                quarantined=list(router.quarantined), batches=len(batches),
                buckets=sorted({bl["bucket"] for bl in batches}),
                batch_p50_ms=float(np.percentile([bl["seconds"] for bl in batches], 50) * 1e3)
                if batches else None,
                batch_ms_by_bucket={b: dict(n=len(v), p50=float(np.percentile(v, 50)),
                                            max=max(v)) for b, v in sorted(by_bucket.items())},
                hedged_p99_ms=float(np.percentile(hedged, 99)) if hedged else None,
                launches=launches)


def run_router(name, services, cfg, qids, router_kw, rate=None, seed=0, deadline_s=None,
               before_drive=None):
    """One scenario: a Router over ``services``, the drive, the shared gates;
    returns (row, router, tickets, outcomes, swapped flags)."""
    import torch

    from repro_torch import kernels
    from repro_torch.launch.router import Router

    router = Router(services, **router_kw)
    try:
        if before_drive is not None:
            before_drive(router)
        torch.cuda.synchronize()
        kernels.reset_launches()
        tickets, outs, wall, swapped = drive_router(router, qids, rate, seed, deadline_s)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    finally:
        router.close()
    return router_gates(name, router, cfg, tickets, outs, wall, launches), router, tickets, \
        outs, swapped


MID_SEARCH_ATTEMPTS = 8


def prefix_consistency(ce, index):
    """One deterministic service (bucket [64]) answers 64 requests with an
    expired deadline, then 64 with a mid-search one: its budget is bisected
    between round 0's time and the full search's until the cut falls
    inside rounds 1..4 (a window of ~10-40 ms after a round 0 of ~150 ms,
    narrower than the spread of round 0 across searches).  Every answer,
    cut or not, must equal bit for bit an explicit search(...,
    n_rounds=rounds_completed) with the service's key on the same rows.
    Returns (rows, the service's launches)."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core.engine import ce_call_plan
    from repro_torch.launch.serve import RetrievalRequest

    cfg = router_cfg()
    (svc,) = router_services(ce, index, cfg, 1, buckets=(64,), deterministic=True)
    qids = [500 + i % 100 for i in range(64)]
    def timed(n_rounds):
        t0 = time.perf_counter()
        svc.retriever.search(torch.tensor(qids, device=index.device), svc._key,
                             n_rounds=n_rounds)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed(None)                  # warm
    timed(1)
    round0_s = float(np.median([timed(1) for _ in range(3)]))
    full_s = float(np.median([timed(None) for _ in range(3)]))
    launches = {"approx_topk": 0, "persistent_round": 0}

    def serve(label, budget) -> dict:
        kernels.reset_launches()
        deadline_t = time.monotonic() + budget
        served = []
        for q in qids:
            served += svc.submit(RetrievalRequest(query_id=q, deadline_t=deadline_t)) or []
        served += svc.flush()
        torch.cuda.synchronize()
        for k in launches:
            launches[k] += kernels.launch_counts()[k]
        check(len(served) == 64 and all(r.status == "ok" for r in served),
              f"router prefix {label}: {len(served)} responses, errors "
              f"{[r.error for r in served if r.status != 'ok'][:1]}")
        rounds = served[0].rounds_completed
        degraded = {r.degraded for r in served}
        check(degraded == {rounds < cfg.n_rounds},
              f"router prefix {label}: rounds {rounds}, degraded {degraded}")
        bl = svc.batch_log[-1]
        check(bl["ce_calls"] == ce_call_plan(cfg, rounds) * 64,
              f"router prefix {label}: CE {bl['ce_calls']} != plan x 64")
        ref = svc.retriever.search(torch.tensor(qids, device=index.device), svc._key,
                                   n_rounds=rounds)
        ref_ids = index.gather_item_ids(ref.topk_idx).cpu().numpy()
        ref_scores = ref.topk_scores.cpu().numpy()
        got_ids = np.stack([r.item_ids for r in served])
        got_scores = np.stack([r.scores for r in served])
        bitwise = bool(np.array_equal(got_ids, ref_ids)
                       and np.array_equal(got_scores.view(np.uint32), ref_scores.view(np.uint32)))
        check(bitwise, f"router prefix {label}: the answer of {rounds} rounds differs "
                       f"from search(n_rounds={rounds}) in "
                       f"{int((got_ids != ref_ids).any(1).sum())} rows")
        return dict(deadline=label, budget_s=budget, round0_s=round0_s, full_search_s=full_s,
                    rounds_completed=rounds, bitwise_equal=bitwise)

    rows = [serve("expired", -1.0)]
    check(rows[0]["rounds_completed"] == 1,
          f"router prefix expired: {rows[0]['rounds_completed']} rounds, not round 0 alone")
    lo, hi = round0_s, full_s
    for attempt in range(MID_SEARCH_ATTEMPTS):
        row = serve("mid_search", 0.5 * (lo + hi))
        rows.append(dict(row, attempt=attempt))
        if row["rounds_completed"] == cfg.n_rounds:
            hi = row["budget_s"]
        elif row["rounds_completed"] == 1:
            lo = row["budget_s"]
        else:
            break
    check(1 < rows[-1]["rounds_completed"] < cfg.n_rounds,
          f"router prefix mid_search: no budget of {MID_SEARCH_ATTEMPTS} cut the search inside "
          f"rounds 1..4: {[(r['budget_s'], r['rounds_completed']) for r in rows[1:]]}")
    return rows, launches


def phase_router(dev, ce, index):
    """The fault-tolerant serving tier on the card: Routers over
    AdaCURService replicas that share the serve domain's index (k_q = 500,
    N = 10^6, fp32, one copy), each replica on its own CUDA stream, with
    ``AdaCURConfig(k_anchor=100, n_rounds=5, budget_ce=200, topk, fori,
    fused)``, anytime retrievers, ``max_batch=64``, buckets [16, 32, 64] and
    one FaultyScorer over the domain each.  Scenarios (256 requests each,
    arrivals Poisson from a seeded generator unless closed-loop):
    capacity (closed loops of 2,048 requests, 1 and 2 replicas, staged and
    persistent, each run three times interleaved: QPS with its spread and
    the 2-over-1-replica ratio of each repeat, p50/p99, peak memory; the
    device-busy share from one profiled 256-request run each); baseline (2
    staged replicas at half the 2-replica closed-loop QPS); scorer_fault
    (replica 0 raises on every call: quarantined, every request ok);
    slow_replica (replica 0 stalls 4x the baseline p50 batch time; hedging
    after the baseline p99; p99 <= 2x baseline p99 + 50 ms); swap_midflight
    (swap_index at admission 128 to the same payload under ids + 10^7 with
    every 100th item removed: no mixed response, every later request in the
    new namespace, no removed id); deadline_degraded (deadlines of half the
    baseline p50 batch time: 1 <= rounds < 5 where degraded).  Every
    scenario: one terminal outcome per request, stats add up, every batch's
    CE = plan x bucket, approx_topk launched from the replica threads.
    Then prefix consistency on the card (an expired and a mid-search
    deadline, bitwise).  Runs under a faulthandler
    watchdog: a deadlocked router ends the run.  Returns (result,
    {kernel: launches})."""
    import dataclasses
    import faulthandler

    import numpy as np
    import torch

    from repro_torch.launch.faults import FaultPlan, ScorerFault, SleepFault, SwapFault

    faulthandler.dump_traceback_later(ROUTER_WATCHDOG_S, exit=True)
    try:
        n = ROUTER_N_REQUESTS
        qids = np.random.default_rng(1).integers(500, 600, n)
        launches = {"approx_topk": 0, "persistent_round": 0}

        def counted(row):
            for k in launches:
                launches[k] += row["launches"][k]
            return row

        closed = dict(queue_limit=CAPACITY_REQUESTS, **LAX_WATCHDOG)
        # warm: cuBLAS / cuSOLVER handles of the replica threads, the kernels'
        # first launches (not counted)
        for rk in ("staged", "persistent"):
            run_router(f"warm {rk}", router_services(ce, index, router_cfg(rk), 2),
                       router_cfg(rk), qids[:128], closed)

        cap_qids = np.random.default_rng(1).integers(500, 600, CAPACITY_REQUESTS)
        runs = {(rk, reps): [] for rk in ("staged", "persistent") for reps in (1, 2)}
        for attempt in range(CAPACITY_REPEATS):
            for (rk, reps), done in runs.items():
                cfg = router_cfg(rk)
                name = f"capacity {rk} x{reps} run {attempt}"
                base_mem = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                row, *_ = run_router(name, router_services(ce, index, cfg, reps), cfg,
                                     cap_qids, closed)
                row["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
                row["peak_over_resident_gb"] = (torch.cuda.max_memory_allocated()
                                                - base_mem) / 1e9
                searches = row["batches"]
                expect = ({"approx_topk": 5 * searches, "persistent_round": 0} if rk == "staged"
                          else {"approx_topk": searches, "persistent_round": 4 * searches})
                got = {k: row["launches"][k] for k in expect}
                check(got == expect, f"router {name}: launches {got}, expected {expect}")
                check(row["ok"] == CAPACITY_REQUESTS,
                      f"router {name}: {row['ok']} ok of {CAPACITY_REQUESTS}")
                done.append(counted(row))
        capacity = []
        for (rk, reps), done in runs.items():
            cfg = router_cfg(rk)
            name = f"capacity {rk} x{reps}"
            qps = [r["qps"] for r in done]
            busy = profile_call(lambda: run_router(
                name + " profiled", router_services(ce, index, cfg, reps), cfg, qids, closed))
            # the profiler slows the host loop: the device's busy time per
            # request at the unprofiled runs' median rate is the other estimate
            busy["device_busy_share_at_unprofiled_rate"] = (
                busy["device_busy_ms"] / 1e3 / n * float(np.median(qps)))
            keep = ("wall_s", "qps", "p50_ms", "p99_ms", "batches", "peak_memory_gb",
                    "peak_over_resident_gb")
            capacity.append(dict(round_kernel=rk, replicas=reps, requests=CAPACITY_REQUESTS,
                                 qps_median=float(np.median(qps)), qps_min=min(qps),
                                 qps_max=max(qps),
                                 runs=[{k: r[k] for k in keep} for r in done],
                                 launches=done[-1]["launches"],
                                 profiled_requests=n, profiled=busy))
        # each round's 2-replica QPS over the 1-replica QPS of the same repeat
        ratios = {rk: [two["qps"] / one["qps"] for one, two in zip(runs[(rk, 1)], runs[(rk, 2)])]
                  for rk in ("staged", "persistent")}
        qps2 = next(c["qps_median"] for c in capacity
                    if c["round_kernel"] == "staged" and c["replicas"] == 2)
        rate = 0.5 * qps2
        cfg = router_cfg()
        lax = dict(queue_limit=n, **LAX_WATCHDOG)

        row, router, *_ = run_router("baseline", router_services(ce, index, cfg, 2), cfg, qids,
                                     lax, rate=rate, seed=2)
        check(row["ok"] == n and row["quarantines"] == 0, f"router baseline: {row}")
        baseline = counted(row)
        healthy = [bl["seconds"] for rep in router.replicas for bl in rep.service.batch_log]
        p50_batch_s = float(np.percentile(healthy, 50))
        p99_s = baseline["p99_ms"] / 1e3

        plan = FaultPlan(scorer_faults=[ScorerFault(call_k=k, replica=0) for k in range(1, 2000)])
        row, *_ = run_router("scorer_fault", router_services(ce, index, cfg, 2, plan), cfg, qids,
                             dict(lax, plan=plan, max_retries=2, max_consecutive_errors=2),
                             rate=rate, seed=3)
        check(row["ok"] == n and row["errors"] == 0 and row["quarantined"] == [0],
              f"router scorer_fault: {row}")
        scorer_fault = counted(row)

        stall_s = 4 * p50_batch_s
        plan = FaultPlan(sleep_faults=[SleepFault(replica=0, seconds=stall_s)])

        def seed_baseline(router):
            # the fleet baseline: the baseline scenario's healthy batches
            router.replicas[1].watchdog.window.extend(healthy)

        row, *_ = run_router("slow_replica", router_services(ce, index, cfg, 2, plan), cfg, qids,
                             # patience 1, as the reference's load run: the
                             # stalled replica looks idle to dispatch (its
                             # queue is empty while it sleeps) until quarantined
                             dict(queue_limit=n, plan=plan, hedge_after_s=p99_s,
                                  watchdog_threshold=3.0, watchdog_patience=1),
                             rate=rate, seed=4, before_drive=seed_baseline)
        bound_ms = 2 * baseline["p99_ms"] + 50.0
        row.update(stall_s=stall_s, hedge_after_ms=p99_s * 1e3, p99_bound_ms=bound_ms)
        check(row["ok"] == n and row["p99_ms"] <= bound_ms,
              f"router slow_replica: p99 {row['p99_ms']} ms > {bound_ms} ms or not all ok: {row}")
        slow = counted(row)

        removed = index.item_ids[:index.n_items:100] + SWAP_OFFSET
        new_index = dataclasses.replace(
            index, item_ids=torch.where(index.item_ids >= 0, index.item_ids + SWAP_OFFSET, -1)
        ).remove_items(removed)
        removed_host = removed.cpu().numpy()
        plan = FaultPlan(swap_faults=[SwapFault(at_seq=128)])
        row, router, tickets, outs, swapped = run_router(
            "swap_midflight", router_services(ce, index, cfg, 2), cfg, qids,
            dict(lax, plan=plan, swap_index_fn=lambda: new_index), rate=rate, seed=5)
        mixed = late_old = removed_served = new_answers = 0
        for o, after in zip(outs, swapped):
            if o.status != "ok":
                continue
            ids = o.response.item_ids
            old, new = bool((ids < SWAP_OFFSET).all()), bool((ids >= SWAP_OFFSET).all())
            mixed += not (old or new)
            late_old += after and not new
            new_answers += new
            removed_served += int(np.isin(ids, removed_host).sum()) if new else 0
        row.update(swaps=router.stats["swaps"], swapped_at_admission=128, mixed=mixed,
                   old_after_swap=late_old, new_namespace_answers=new_answers,
                   removed_ids_served=removed_served, removed=int(removed.numel()))
        check(row["ok"] == n and row["swaps"] == 1 and mixed == 0 and late_old == 0
              and removed_served == 0 and new_answers >= n - 128,
              f"router swap_midflight: {row}")
        swap = counted(row)
        del new_index

        deadline_s = 0.5 * p50_batch_s
        row, router, tickets, outs, _ = run_router(
            "deadline_degraded", router_services(ce, index, cfg, 2), cfg, qids, lax,
            rate=rate, seed=6, deadline_s=deadline_s)
        bad = [o.response.rounds_completed for o in outs
               if o.status == "ok" and o.degraded
               and not 1 <= o.response.rounds_completed < cfg.n_rounds]
        rounds = [bl["rounds"] for rep in router.replicas for bl in rep.service.batch_log]
        row.update(deadline_ms=deadline_s * 1e3,
                   rounds_histogram={r: rounds.count(r) for r in sorted(set(rounds))})
        check(row["ok"] == n and not bad and row["degraded"] > 0,
              f"router deadline_degraded: degraded rounds {bad[:5]}, {row}")
        deadline = counted(row)

        prefix, prefix_launches = prefix_consistency(ce, index)
        for k in launches:
            launches[k] += prefix_launches[k]
        check(launches["persistent_round"] > 0, "router: persistent_round never launched")
    finally:
        faulthandler.cancel_dump_traceback_later()
    return dict(n_items=index.n_items, requests_per_scenario=n, arrival_rate_qps=rate,
                capacity=capacity, capacity_qps_ratio_2_over_1=ratios, baseline=baseline, scorer_fault=scorer_fault,
                slow_replica=slow, swap_midflight=swap, deadline_degraded=deadline,
                prefix_consistency=prefix, launches=launches), launches


def phase_retrievers_cpu_vs_card(dev):
    """The five methods of the quality matrix (eval.harness.method_retrievers,
    with the BM25-hybrid) and both hybrids in subset mode on the card
    (kernels) and on the CPU (plain versions), N = 20,000, B = 64, fp32 and
    int8: top-k overlap >= 0.99 per method, measured CE equal.  The searches use the full pinv (``incremental_pinv=False``), as
    the reference allows: at 100 anchors in 5 rounds the bordered update's
    fp32 estimate is unstable in the reference itself (ROADMAP queue 3), so
    one ulp of rounding moves its top-k and card against CPU would compare
    rounding, not kernels."""
    import dataclasses

    import torch

    from repro_torch import kernels
    from repro_torch.core import prng
    from repro_torch.core.candidates import (BM25Candidates, DualEncoderCandidates,
                                             HybridRetriever)
    from repro_torch.core.index import AnchorIndex
    from repro_torch.core.scorer import TabulatedScorer, scorer_stats
    from repro_torch.data.synthetic import lexical_signatures, make_synthetic_ce
    from repro_torch.eval.harness import matrix_config, method_retrievers
    from repro_torch.testing import topk_overlap

    ce = make_synthetic_ce(prng.PRNGKey(7), n_queries=264, n_items=20000, device="cpu")
    index = AnchorIndex.build(ce.score_block, torch.arange(200), torch.arange(20000))
    matrix = ce.full_matrix(torch.arange(264))
    tokens = (lexical_signatures(ce.i_emb, seed=3), lexical_signatures(ce.q_emb, seed=3))
    q = torch.arange(200, 264)
    out = []
    for payload in ("float32", "int8"):
        cfg = dataclasses.replace(matrix_config(200, 5, (1, 10, 100), use_fused_topk=True,
                                                payload_dtype=payload), incremental_pinv=False)
        idx = index.quantize(payload)
        sides = {}
        for side, d in (("cpu", "cpu"), ("card", dev)):
            kernels.reset_launches()
            res = {}
            ce_d, idx_d, matrix_d = ce.to(d), idx.to(d), matrix.to(d)
            methods = method_retrievers(ce_d, idx_d, matrix_d, cfg, 800, corpus_tokens=tokens[0],
                                        query_tokens=tokens[1])
            for name, gen in (("hybrid_de", DualEncoderCandidates(ce_d.q_emb, ce_d.i_emb)),
                              ("hybrid_bm25", BM25Candidates(*tokens, device=d))):
                methods.append((f"{name}_subset", HybridRetriever(
                    score_fn=TabulatedScorer(matrix_d), generator=gen, cfg=cfg, index=idx_d,
                    shortlist_k=800, mode="subset"), None))
            for name, ret, kw in methods:
                qd = q.to(d)
                before = scorer_stats(ret.score_fn).ce_calls
                r = ret.search(qd, prng.PRNGKey(0), **(kw(qd) if kw else {}))
                res[name] = (r.topk_idx.cpu(), scorer_stats(ret.score_fn).ce_calls - before)
            sides[side] = (res, kernels.launch_counts())
        for name in sides["cpu"][0]:
            (ci, cce), (gi, gce) = sides["cpu"][0][name], sides["card"][0][name]
            ov = topk_overlap(ci, gi)
            check(ov >= 0.99, f"retrievers card vs CPU: {name} {payload} overlap {ov} < 0.99")
            check(cce == gce, f"retrievers card vs CPU: {name} {payload} CE {gce} vs {cce}")
            out.append(dict(method=name, payload=payload, overlap=ov, measured_ce_total=gce))
        cpu_l, card_l = sides["cpu"][1], sides["card"][1]
        check(cpu_l["approx_topk"] == 0 and card_l["approx_topk"] > 0,
              f"retrievers card vs CPU {payload}: launches CPU {cpu_l}, card {card_l}")
    return out


def phase_engine_cpu_vs_card(dev):
    """The same search on the card and on the CPU, for every payload, with
    the incremental pinv the serve path runs (top-k overlap >= 0.99).  The
    early-exit persistent config runs the software-pipelined monitored loop:
    every sweep launches ``persistent_round`` with both lists (sample +
    provisional monitor), so the card makes one launch per round done and
    one ``approx_topk`` (the rerank) in all.  It stops before its last
    round, on both devices alike, and uses the full regularized pinv."""
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
               dict(payload_dtype="bfloat16"), dict(payload_dtype="fp8"),
               dict(payload_dtype="int4"), dict(payload_dtype="int4", round_kernel="persistent"),
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
            expect = {"approx_topk": 1, "persistent_round": int(card.rounds_done),
                      "flash_attention": 0, "embedding_bag": 0, "embedding_bag_backward": 0}
        else:
            expect = ({"approx_topk": cfg.n_rounds, "persistent_round": 0}
                      if cfg.round_kernel == "staged"
                      else {"approx_topk": 1, "persistent_round": cfg.n_rounds - 1})
            expect.update(flash_attention=0, embedding_bag=0, embedding_bag_backward=0)
        check(counts == expect, f"engine {kw}: launches {counts}, expected {expect}")
        out.append(dict(config=kw or "fp32 staged", overlap=ov, launches=counts,
                        rounds_done_card=int(card.rounds_done),
                        rounds_done_cpu=int(cpu.rounds_done)))
    return out


def flash_work(b, lq, lk, h, kv, hd, causal, lens, elem) -> tuple:
    """(bytes, FLOPs) this input's masks leave to do, summed over the batch
    (key tiles past a row's length or above the causal diagonal are
    skipped): q is read for the rows that see a key, k and v for the keys
    some row sees, every output row is written, kv_lens read once."""
    import numpy as np

    rows = np.arange(lq)
    pairs = q_rows = keys = 0
    for i in range(b):
        limit = lk if lens is None else min(lk, lens[i])
        per_row = np.minimum(limit, lk - lq + rows + 1) if causal else np.full(lq, limit)
        per_row = np.clip(per_row, 0, None)
        pairs += int(per_row.sum())
        q_rows += int((per_row > 0).sum())
        keys += int(per_row.max())
    nb = (q_rows * h + 2 * keys * kv + b * lq * h) * hd * elem + (0 if lens is None else 4 * b)
    return nb, 4.0 * hd * h * pairs


def flash_case(dev, gen, reps, case, b, lq, lk, h, kv, hd, causal, lens, dtype):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain,
    )
    from repro_torch.testing import FLASH_TOL

    dt = getattr(torch, dtype)
    q = torch.randn((b, lq, h, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((b, lk, kv, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((b, lk, kv, hd), generator=gen, device=dev).to(dt)
    kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
    out = flash_attention(q, k, v, causal=causal, kv_lens=kv_lens)
    ref = flash_attention_plain(q, k, v, causal=causal, kv_lens=kv_lens)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    atol, rtol = FLASH_TOL[dtype]
    ok = bool((err <= atol + rtol * ref.float().abs()).all())
    check(ok, f"flash_attention {case} {dtype} disagrees with its plain version: "
              f"max abs err {err.max().item()}")
    zero_rows = [i for i, n in enumerate(lens or []) if n == 0]
    check(all(torch.count_nonzero(out[i]).item() == 0 for i in zero_rows),
          f"flash_attention {case} {dtype}: a length-0 example is not all zeros")
    # the library yardstick: SDPA with an explicit boolean mask (B, 1, Lq, Lk)
    kpos = torch.arange(lk, device=dev)
    lim = torch.full((b,), lk, device=dev) if kv_lens is None else kv_lens
    mask = (kpos[None, :] < lim[:, None])[:, None, None, :]
    if causal:
        qpos = (lk - lq) + torch.arange(lq, device=dev)
        mask = mask & (kpos[None, :] <= qpos[:, None])[None, None]
    mask = mask.expand(b, 1, lq, lk)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal, kv_lens=kv_lens), reps)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=causal,
                                                     kv_lens=kv_lens), 2)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), reps)
    nb, flops = flash_work(b, lq, lk, h, kv, hd, causal, lens, q.element_size())
    b_ms, b_by = bound(nb, flops, PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_FP32_FLOPS)
    # the bf16 kernel's own work: Q K^T once, P V once per bf16 term of p
    split_ms = (bound(nb, flops * (1 + FLASH_P_TERMS) / 2, PEAK_BF16_FLOPS)[0]
                if dtype == "bfloat16" else None)
    return dict(case=case, dtype=dtype, B=b, Lq=lq, Lk=lk, H=h, KV=kv, hd=hd,
                causal=causal, kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, bound_split_ms=split_ms, bytes=nb, flops=flops,
                max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
                zero_rows=len(zero_rows))


def phase_flash(gen, dev, quick):
    """Returns (rows, worst max abs err); rows[0] is the CE serving shape
    (64 pairs, bf16)."""
    import numpy as np

    from repro_torch.configs.registry import CE_TINY, QWEN3_8B_ATTENTION
    from repro_torch.data.synthetic import make_zeshel_like

    ds = make_zeshel_like(0, n_items=16, n_queries=4, item_len=24, query_len=16)
    pair_len = ds.pair_tokens(np.zeros(1, np.int64), np.zeros((1, 1), np.int64)).shape[-1]
    ce = dict(lq=64, lk=64, h=CE_TINY.n_heads, kv=CE_TINY.n_kv_heads,
              hd=CE_TINY.resolved_head_dim, causal=False)
    qw = dict(h=QWEN3_8B_ATTENTION["n_heads"], kv=QWEN3_8B_ATTENTION["n_kv_heads"],
              hd=QWEN3_8B_ATTENTION["head_dim"])
    lq_big = 256 if quick else 2048
    cases = []
    for b in (64, 1024):
        lens = [pair_len] * (b - b // 8) + [0] * (b // 8)       # 1/8 pad rows
        for dtype in ("bfloat16", "float32"):
            cases.append(dict(case=f"ce {b} pairs", b=b, lens=lens, dtype=dtype, **ce))
    for causal, dtype in ((True, "bfloat16"), (False, "bfloat16"), (False, "float32")):
        cases.append(dict(case="qwen3-8b attention", b=2, lq=lq_big, lk=lq_big,
                          causal=causal, lens=[lq_big, lq_big * 2 // 3],
                          dtype=dtype, **qw))
    for dtype in ("float32", "bfloat16"):
        cases.append(dict(case="decode chunk", b=4, lq=64, lk=192, h=8, kv=4, hd=64,
                          causal=True, lens=[192, 150, 100, 40], dtype=dtype))
    rows = [flash_case(dev, gen, 5 if c["lq"] > 256 else 20, **c) for c in cases]
    return rows, max(r["max_abs_err"] for r in rows)


def phase_serve_real_ce(dev):
    """ce-tiny at full width (bf16) serving real-CE ADACUR on the card."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.configs.registry import CE_TINY
    from repro_torch.core import prng
    from repro_torch.core.engine import AdaCURRetriever, ce_call_plan
    from repro_torch.core.scorer import CachingScorer, CrossEncoderScorer
    from repro_torch.eval.metrics import exact_topk, topk_recall
    from repro_torch.launch.serve import AdaCURService, build_real_ce_domain, drive

    n_items, n_anchor, n_serve, n_requests = 10_000, 100, 100, 200
    t0 = time.perf_counter()
    ds, params, scorer, index = build_real_ce_domain(
        n_items, n_anchor, n_serve, cfg=CE_TINY, device=dev, micro_batch=64,
        build_micro_batch=1024)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # the exact CE scores of the served queries: the same model, counted nowhere
    exact = CrossEncoderScorer(params, CE_TINY, ds.pair_tokens, micro_batch=1024)
    items = torch.arange(n_items, device=dev)
    t0 = time.perf_counter()
    m = torch.cat([exact.score_block(torch.arange(lo, min(lo + 25, n_anchor + n_serve)),
                                     items) for lo in range(n_anchor, n_anchor + n_serve, 25)])
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    check(bool(torch.isfinite(m).all()), "real-CE scores are not all finite")
    _, gt = exact_topk(m, 50)
    gt = gt.cpu()
    cfg = AdaCURConfig(k_anchor=100, n_rounds=5, budget_ce=200, strategy="topk",
                       k_retrieve=50, loop_mode="fori", use_fused_topk=True)
    plan = ce_call_plan(cfg)
    results, launches = [], {"approx_topk": 0, "persistent_round": 0, "flash_attention": 0}
    for label in ("no cache", "cache"):
        serve_fn = CachingScorer(scorer) if label == "cache" else scorer
        svc = AdaCURService(retriever=AdaCURRetriever.from_index(index, serve_fn, cfg),
                            max_batch=16)
        scorer.reset_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        served = drive(svc, n_requests, qid_range=(n_anchor, n_anchor + n_serve))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        n_search = len(svc.batch_log)
        errors = [r.error for r in served if r.status != "ok"]
        check(not errors, f"serve_real_ce {label}: {len(errors)} error responses, "
                          f"first: {errors[:1]}")
        check(len(served) == n_requests,
              f"serve_real_ce {label}: {len(served)} responses for {n_requests} requests")
        for bl in svc.batch_log:
            if label == "cache":
                check(bl["pairs"] == plan * bl["bucket"]
                      and bl["ce_calls"] + bl["cache_hits"] <= bl["pairs"],
                      f"serve_real_ce cache: batch {bl} against plan {plan}")
            else:
                check(bl["ce_calls"] == plan * bl["bucket"],
                      f"serve_real_ce: measured CE {bl['ce_calls']} != plan {plan} x "
                      f"{bl['bucket']}")
        hits = sum(bl["cache_hits"] for bl in svc.batch_log)
        check(label != "cache" or hits > 0, "serve_real_ce cache: no cache hits")
        n_fwd = scorer.forwards
        expect = {"approx_topk": 5 * n_search, "persistent_round": 0,
                  "flash_attention": CE_TINY.n_layers * n_fwd, "embedding_bag": 0,
                  "embedding_bag_backward": 0}
        check(counts == expect and n_fwd > 0,
              f"serve_real_ce {label}: launches {counts}, expected {expect}")
        for name in launches:
            launches[name] += counts[name]
        for r in served:
            check(r.item_ids.shape == (50,) and np.isfinite(r.scores).all()
                  and ((r.item_ids >= 0) & (r.item_ids < n_items)).all(),
                  f"serve_real_ce {label}: malformed response for query {r.query_id}")
        retrieved = torch.as_tensor(np.stack([r.item_ids for r in served]))
        rows = gt[[r.query_id - n_anchor for r in served]]
        secs = [bl["seconds"] for bl in svc.batch_log]
        results.append(dict(
            config=label, requests=len(served), searches=n_search,
            buckets=[bl["bucket"] for bl in svc.batch_log],
            per_search_ms=float(np.mean(secs) * 1e3),
            batch_p50_ms=float(np.percentile(secs, 50) * 1e3),
            batch_p99_ms=float(np.percentile(secs, 99) * 1e3),
            drive_s=wall, ce_forwards=n_fwd, ce_forwards_per_s=n_fwd / wall,
            ce_calls=scorer.stats.ce_calls, ce_calls_per_s=scorer.stats.ce_calls / wall,
            cache_hits=hits, launches=counts, ce_plan=plan, errors=len(errors),
            **{f"recall@{k}": topk_recall(retrieved, rows, k) for k in (1, 10, 50)},
        ))
    retriever = AdaCURRetriever.from_index(index, scorer, cfg)
    qids = torch.arange(n_anchor, n_anchor + 16, device=dev)
    profiled = profile_call(lambda: retriever.search(qids, prng.PRNGKey(5)))
    return dict(model="ce-tiny", dtype=CE_TINY.dtype, n_items=n_items,
                anchor_queries=n_anchor, served_queries=n_serve,
                index_build_s=build_s, exact_scores_s=exact_s, configs=results,
                profile_B16=profiled), launches


def phase_ce_cpu_vs_card(dev):
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs.base import replace
    from repro_torch.configs.registry import CE_TINY
    from repro_torch.data.synthetic import make_zeshel_like
    from repro_torch.device import to_device
    from repro_torch.models.cross_encoder import init_cross_encoder, score_tokens

    ds = make_zeshel_like(1, n_items=1000, n_queries=100, item_len=24, query_len=16)
    rng = np.random.default_rng(0)
    pairs = ds.pair_tokens(rng.integers(0, 100, 256), rng.integers(0, 1000, (256, 1)))[:, 0]
    toks = torch.zeros((256, 64), dtype=torch.int32)
    toks[:, :pairs.shape[1]] = torch.from_numpy(pairs)
    out = []
    for dtype in ("float32", "bfloat16"):
        cfg = replace(CE_TINY, dtype=dtype)
        params = init_cross_encoder(cfg, torch.Generator().manual_seed(1), "cpu")
        kernels.reset_launches()
        card = score_tokens(to_device(params, dev), toks.to(dev), cfg, attn_impl="flash")
        torch.cuda.synchronize()
        n_launch = kernels.launch_counts()["flash_attention"]
        check(n_launch == cfg.n_layers, f"ce_cpu_vs_card {dtype}: {n_launch} flash launches")
        cpu = score_tokens(params, toks, cfg, attn_impl="flash", flash_block=(64, 64))
        d = (card.cpu() - cpu).abs().max().item()
        top = cpu.abs().max().item()
        if dtype == "float32":
            check(d <= 1e-4 * top, f"ce_cpu_vs_card fp32: max |dscore| {d} > 1e-4 x {top}")
        out.append(dict(dtype=dtype, pairs=256, max_abs_dscore=d, max_abs_score=top,
                        rel=d / top, checked=dtype == "float32"))
    return out


def bag_case(dev, gen, reps, case, table, b, h, mode):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag.ops import embedding_bag_op
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_plain

    rows, dim = table.shape
    ids = torch.randint(0, rows, (b, h), generator=gen, device=dev, dtype=torch.int32)
    out = embedding_bag_op(table, ids, mode)
    ref = embedding_bag_plain(table, ids, mode)
    torch.cuda.synchronize()
    dtype = str(table.dtype).replace("torch.", "")
    err = (out.float() - ref.float()).abs()
    atol, rtol = BAG_TOL[dtype]
    check(bool((err <= atol + rtol * ref.float().abs()).all()),
          f"embedding_bag {case} {dtype} {mode} disagrees with its plain version: "
          f"max abs err {err.max().item()}")
    bitwise = torch.equal(out, ref)
    check(h > 1 or bitwise, f"embedding_bag {case}: a one-id bag is not bitwise equal")
    ids64 = ids.long()
    ms = cuda_ms(lambda: embedding_bag_op(table, ids, mode), reps)
    plain_ms = cuda_ms(lambda: embedding_bag_plain(table, ids, mode), 2)
    lib_ms = cuda_ms(lambda: F.embedding_bag(ids64, table, mode=mode), reps)
    elem = table.element_size()
    nb = b * h * dim * elem + b * dim * elem + 4 * b * h
    b_ms, b_by = bound(nb, float(b * h * dim))
    return dict(case=case, dtype=dtype, mode=mode, B=b, H=h, dim=dim, rows=rows,
                kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, bytes=nb, max_abs_err=err.max().item(), bitwise=bitwise)


def phase_embedding_bag(gen, dev, quick):
    """Returns (rows, worst max abs err); rows[0] is case (a), DLRM's
    per-field lookup at serve_bulk."""
    import torch

    rows = (1 << 16) if quick else (1 << 24)
    table = torch.randn((rows, 128), generator=gen, device=dev)
    big, small, multi = (4096, 512, 1024) if quick else (262144, 512, 65536)
    out = [bag_case(dev, gen, 20, "(a) dlrm field, serve_bulk", table, big, 1, "sum"),
           bag_case(dev, gen, 50, "(b) dlrm field, serve_p99", table, small, 1, "sum")]
    for dtype in ("float32", "bfloat16"):
        t = table if dtype == "float32" else table.to(torch.bfloat16)
        for mode in ("sum", "mean"):
            out.append(bag_case(dev, gen, 10, "(c) multi-hot", t, multi, 32, mode))
        del t
    del table
    torch.cuda.empty_cache()
    return out, max(r["max_abs_err"] for r in out)


def phase_recsys_serve(dev, params, cfg):
    """dlrm-mlperf's serve steps on the card; returns (result, bag launches)."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.launch import steps

    results, launches = [], 0
    for name, n_steps in (("serve_p99", 50), ("serve_bulk", 10)):
        shape = RECSYS_SHAPES[name]
        bundle = steps.build_recsys_serve(DLRM, cfg, shape, params=params)
        out = bundle.step(*bundle.args)                   # warm-up
        torch.cuda.synchronize()
        check(out.shape == (shape.batch,) and bool(torch.isfinite(out).all()),
              f"recsys_serve {name}: logits not finite of shape ({shape.batch},)")
        del out
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        secs = []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            bundle.step(*bundle.args)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        counts = kernels.launch_counts()
        per_step = counts["embedding_bag"] / n_steps
        check(per_step == cfg.n_sparse,
              f"recsys_serve {name}: {per_step} bag launches a step, expected {cfg.n_sparse}")
        launches += counts["embedding_bag"]
        med = float(np.median(secs))
        results.append(dict(
            shape=name, batch=shape.batch, steps=n_steps, median_ms=med * 1e3,
            min_ms=min(secs) * 1e3, model_flops=bundle.model_flops,
            tflops=bundle.model_flops / med / 1e12,
            fp32_peak_share=bundle.model_flops / med / PEAK_FP32_FLOPS,
            bag_launches_per_step=per_step,
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
            profile=profile_call(lambda: bundle.step(*bundle.args))))
        del bundle
    return results, launches


def phase_recsys_retrieval(dev, params, cfg, n_search=16):
    """ADACUR over 10^6 candidates with DLRM as the scorer; returns
    (result, {kernel: launches})."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs.base import replace
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.core import prng
    from repro_torch.core.engine import engine_search
    from repro_torch.eval.metrics import exact_topk, topk_recall
    from repro_torch.launch import steps
    from repro_torch.models.recsys import dlrm, embedding
    from repro_torch.testing import topk_overlap

    shape = RECSYS_SHAPES["retrieval_cand"]
    n_cand = shape.n_candidates
    t0 = time.perf_counter()
    bundle = steps.build_recsys_retrieval(DLRM, cfg, shape, params=params)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    params, batch, _ = bundle.args
    r_anc = batch["r_anc"]
    check(r_anc.shape == (steps.K_Q, embedding.padded_rows(n_cand))
          and bool(torch.isfinite(r_anc).all()), "recsys_retrieval: R_anc malformed")
    ctx = steps.recsys_inputs(cfg, n_search, seed=7, device=dev)
    t0 = time.perf_counter()
    exact = steps.anchor_scores(params, cfg, ctx, n_cand)[:, :n_cand]
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    _, gt = exact_topk(exact, 100)
    del exact
    queries = [{"dense": ctx["dense"][i:i + 1], "sparse": ctx["sparse"][i:i + 1]}
               for i in range(n_search)]

    bundle.step(params, dict(queries[0], r_anc=r_anc), prng.PRNGKey(99))   # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    ids, secs, calls, errors = [], [], [], []
    ce_before = bundle.stats.ce_calls
    for i, q in enumerate(queries):
        before = bundle.stats.ce_calls
        t0 = time.perf_counter()
        idx, sc = bundle.step(params, dict(q, r_anc=r_anc), prng.PRNGKey(100 + i))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        calls.append(bundle.stats.ce_calls - before)
        row = idx[0].tolist()
        if calls[-1] != steps.RETRIEVAL_CFG.budget_ce:
            errors.append(f"search {i} made {calls[-1]} CE calls, expected "
                          f"{steps.RETRIEVAL_CFG.budget_ce}")
        if not (idx.shape == (1, 100) and len(set(row)) == 100 and max(row) < n_cand
                and min(row) >= 0 and bool(torch.isfinite(sc).all())):
            errors.append(f"search {i} returned a malformed top-100")
        ids.append(idx)
    check(not errors, "recsys_retrieval: " + "; ".join(errors))
    ce_per_search = (bundle.stats.ce_calls - ce_before) / n_search
    counts = kernels.launch_counts()
    # one DLRM forward per CE request: 5 rounds + the rerank
    expect = 26 * (steps.RETRIEVAL_CFG.n_rounds + 1) * n_search
    check(counts["embedding_bag"] == expect,
          f"recsys_retrieval: {counts['embedding_bag']} bag launches, expected {expect}")
    ids = torch.cat(ids)
    recall = {f"recall@{k}": topk_recall(ids, gt, k) for k in (1, 10, 100)}

    ecfg = replace(steps.RETRIEVAL_CFG, use_fused_topk=True)
    e_calls = [0]

    def sf(q, idx):
        e_calls[0] += idx.numel()
        return dlrm.score_candidates(params, q["dense"], q["sparse"], idx, cfg)

    engine_search(sf, r_anc, queries[0], ecfg, prng.PRNGKey(99), n_valid_items=n_cand)
    torch.cuda.synchronize()                                             # warm-up
    e_calls[0] = 0
    kernels.reset_launches()
    e_ids, e_secs = [], []
    for i, q in enumerate(queries):
        t0 = time.perf_counter()
        res = engine_search(sf, r_anc, q, ecfg, prng.PRNGKey(100 + i), n_valid_items=n_cand)
        torch.cuda.synchronize()
        e_secs.append(time.perf_counter() - t0)
        e_ids.append(res.topk_idx)
    e_counts = kernels.launch_counts()
    check(e_calls[0] == ecfg.budget_ce * n_search,
          f"recsys_retrieval engine: {e_calls[0]} CE calls for {n_search} searches")
    check(e_counts["approx_topk"] == ecfg.n_rounds * n_search,
          f"recsys_retrieval engine: approx_topk launches {e_counts}")
    e_ids = torch.cat(e_ids)
    prof = profile_call(lambda: bundle.step(params, dict(queries[0], r_anc=r_anc),
                                            prng.PRNGKey(100)))
    return dict(
        n_candidates=n_cand, k_q=steps.K_Q, r_anc_build_s=build_s,
        r_anc_pairs=steps.K_Q * n_cand, exact_scores_s=exact_s, searches=n_search,
        per_search_ms=float(np.mean(secs) * 1e3),
        per_search_p50_ms=float(np.percentile(secs, 50) * 1e3),
        per_search_max_ms=max(secs) * 1e3,
        ce_calls_per_search=ce_per_search,
        ce_calls_min=min(calls), ce_calls_max=max(calls), errors=len(errors), **recall,
        bag_launches=counts["embedding_bag"], profile_search=prof,
        engine=dict(per_search_ms=float(np.mean(e_secs) * 1e3), launches=e_counts,
                    overlap_with_adacur_search=topk_overlap(ids, e_ids),
                    **{f"recall@{k}": topk_recall(e_ids, gt, k) for k in (1, 10, 100)}),
    ), {"embedding_bag": counts["embedding_bag"] + e_counts["embedding_bag"],
        "approx_topk": e_counts["approx_topk"]}


def phase_dlrm_cpu_vs_card(dev):
    import torch

    from repro_torch import kernels
    from repro_torch.configs import dlrm_mlperf
    from repro_torch.device import to_device
    from repro_torch.launch import steps
    from repro_torch.models.recsys import dlrm, embedding

    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 is on")
    cfg = dlrm_mlperf.capped(max_rows=1 << 16)
    params = dlrm.init_dlrm(cfg, torch.Generator().manual_seed(3), "cpu")
    ctx = steps.recsys_inputs(cfg, 512, seed=4, device="cpu")
    cands = torch.randint(0, 10 ** 6, (512, 64), generator=torch.Generator().manual_seed(5),
                          dtype=torch.int32)
    card_params = to_device(params, dev)
    kernels.reset_launches()
    card = dlrm.score_candidates(card_params, ctx["dense"].to(dev), ctx["sparse"].to(dev),
                                 cands.to(dev), cfg)
    torch.cuda.synchronize()
    n_launch = kernels.launch_counts()["embedding_bag"]
    check(n_launch == cfg.n_sparse, f"dlrm_cpu_vs_card: {n_launch} bag launches")
    t0 = time.perf_counter()
    cpu = dlrm.score_candidates(params, ctx["dense"], ctx["sparse"], cands, cfg)
    cpu_s = time.perf_counter() - t0
    d = (card.cpu() - cpu).abs().max().item()
    top = cpu.abs().max().item()
    check(d <= 1e-4 * top, f"dlrm_cpu_vs_card: max |dscore| {d} > 1e-4 x {top}")
    sparse_r = torch.repeat_interleave(ctx["sparse"], 64, dim=0)
    sparse_r[:, 0] = cands.reshape(-1)
    same = torch.equal(embedding.lookup_all_tables(card_params["tables"], sparse_r.to(dev)).cpu(),
                       embedding.lookup_all_tables(params["tables"], sparse_r))
    check(same, "dlrm_cpu_vs_card: lookups differ between the card and the CPU")
    return dict(pairs=512 * 64, max_abs_dscore=d, max_abs_score=top, rel=d / top,
                lookups_bitwise=same, cpu_s=cpu_s, tf32=False)


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------

TRAIN_WARMUP, TRAIN_TIMED = 2, 10        # DLRM train steps before and in the timing
TRAIN_CPU_CAP, TRAIN_CPU_BATCH, TRAIN_CPU_STEPS = 1 << 16, 512, 3
TRAIN_TOL = 1e-5          # card vs CPU: loss relative, params x the largest |param|
BAG_BWD_TOL = 1e-5        # backward kernel vs plain: max |d| <= this x max |grad|
# the DLRM train step's median ms with the earlier backward design (a library
# sort, a zero fill, a serial walk a tile), on an H100 80GB HBM3 at 700 W:
# printed beside this run's
EARLIER_TRAIN_STEP_MS = 204.7
LM_MEM_SHARE = 0.8        # of the card's memory the ce-tiny train_4k step may plan for
CLI_STEPS = (30, 50)      # the ce-tiny CLI: a run cut at 30, resumed to 50
CLI_SAVE_EVERY = 10


def tree_max_diff(a, b) -> float:
    """The largest |a - b| over two trees of tensors (any devices)."""
    from repro_torch.tree import leaves

    return max(float((x.detach().cpu().float() - y.detach().cpu().float()).abs().max())
               for x, y in zip(leaves(a), leaves(b)))


def tree_equal(a, b) -> bool:
    from repro_torch.tree import leaves, leaves_with_paths

    ka = [k for k, _ in leaves_with_paths(a)]
    return ka == [k for k, _ in leaves_with_paths(b)] and all(
        x.dtype == y.dtype and torch_equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def torch_equal(x, y) -> bool:
    import torch

    return bool(torch.equal(x.detach().cpu(), y.detach().cpu()))


def bag_backward_case(dev, gen, case, rows, b, reps):
    """The bag's backward kernel against its plain version (``index_add_``
    in lookup order) for one DLRM field (H = 1, dim 128) on the card: error
    gate, bitwise equal to the emulation of its order and across two calls,
    times beside the bound and ``zeros`` + ``index_add_``'s."""
    import torch

    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_backward_cuda
    from repro_torch.kernels.embedding_bag.ref import (
        embedding_bag_backward_emulated, embedding_bag_backward_plain, row_keys)

    dim = 128
    g = torch.randn((b, dim), generator=gen, device=dev)
    ids = torch.randint(0, rows, (b, 1), generator=gen, device=dev, dtype=torch.int32)
    out = embedding_bag_backward_cuda(g, ids, rows)
    again = embedding_bag_backward_cuda(g, ids, rows)
    ref = embedding_bag_backward_plain(g, ids, rows)
    emu = embedding_bag_backward_emulated(g, ids, rows)
    torch.cuda.synchronize()
    err, top = (out - ref).abs().max().item(), ref.abs().max().item()
    check(err <= BAG_BWD_TOL * top, f"embedding_bag_backward {case}: max |d| {err} > "
          f"{BAG_BWD_TOL} x max |grad| {top}")
    bits = out.view(torch.int32)
    check(bool(torch.equal(bits, again.view(torch.int32))),
          f"embedding_bag_backward {case}: two calls differ")
    check(bool(torch.equal(bits, emu.view(torch.int32))),
          f"embedding_bag_backward {case}: not bitwise equal to the emulation of its order "
          f"({int((bits != emu.view(torch.int32)).any(1).sum())} rows differ)")
    del again, emu
    keys = row_keys(ids, rows)
    touched = int(torch.unique(keys).numel())
    ms = cuda_ms(lambda: embedding_bag_backward_cuda(g, ids, rows), reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):                 # the host's time to enqueue a call
        embedding_bag_backward_cuda(g, ids, rows)
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    prof = profile_call(lambda: embedding_bag_backward_cuda(g, ids, rows))
    plain_ms = cuda_ms(lambda: embedding_bag_backward_plain(g, ids, rows), 3)
    lib_ms = cuda_ms(lambda: torch.zeros((rows, dim), device=dev).index_add_(0, keys, g), reps)
    # the dense gradient written, grad_out and the ids read once
    nb = rows * dim * 4 + b * dim * 4 + b * 4
    b_ms, b_by = bound(nb, float(b * dim))
    touched_ms, _ = bound(b * dim * 4 + b * 4 + touched * dim * 4, float(b * dim))
    return dict(case=case, B=b, H=1, dim=dim, rows=rows, rows_touched=touched,
                lookups_per_touched_row=b / touched, kernel_ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, bytes=nb,
                bound_touched_ms=touched_ms, bound_share=b_ms / ms, host_ms=host_ms,
                profile=prof, max_abs_err=err,
                max_abs_grad=top, bitwise_across_calls=True, bitwise_vs_emulation=True,
                bitwise_vs_plain=bool(torch.equal(out, ref)))


def phase_bag_backward(gen, dev, quick):
    """Returns (rows, worst max abs err); rows[0] is DLRM's largest training
    table (2^22 rows) at train_batch."""
    b = 4096 if quick else 65536
    rows = [bag_backward_case(dev, gen, "(a) dlrm field, 2^22 rows", 1 << 22, b, 20),
            bag_backward_case(dev, gen, "(b) dlrm small field, 512 rows", 512, b, 20),
            bag_backward_case(dev, gen, "(c) criteo field 5, 3 rows", 3, b, 20)]
    return rows, max(r["max_abs_err"] for r in rows)


def params_copy(params, dev):
    """A copy of a parameter tree on ``dev`` (a train step updates it in
    place)."""
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.to(dev).clone(), params)


def dlrm_train_run(cfg, params, batches, dev):
    """``len(batches)`` DLRM train steps from ``params`` (copied to ``dev``)
    -> (params, opt state, losses)."""
    from repro_torch.configs.base import RecSysShape
    from repro_torch.launch import steps

    bundle = steps.build_recsys_train(DLRM, cfg, RecSysShape("train", "train", 1),
                                      params=params_copy(params, dev))
    params, state, _ = bundle.args
    losses = []
    for batch in batches:
        params, state, met = bundle.step(params, state, {k: v.to(dev) for k, v in batch.items()})
        losses.append(float(met["loss"]))
    return params, state, losses


def phase_train(dev):
    """Training on the card: the full-width DLRM train step (tables capped at
    2^22), card against CPU, determinism, recovery and the ce-tiny CLI's
    resume, the forward-only kernels' autograd guard, and ce-tiny at
    train_4k.  Returns (result, {kernel: launches} of the timed DLRM
    steps)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import dlrm_mlperf
    from repro_torch.configs.registry import CE_TINY
    from repro_torch.configs.shapes import LM_SHAPES, RECSYS_SHAPES
    from repro_torch.launch import steps
    from repro_torch.models.recsys import dlrm
    from repro_torch.tree import leaves

    out = {}
    # (1) dlrm-mlperf at full width, train_batch, tables capped at 2^22
    cfg = dlrm_mlperf.capped(max_rows=dlrm_mlperf.TRAIN_ROW_CAP)
    shape = RECSYS_SHAPES["train_batch"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = steps.build_recsys_train(DLRM, cfg, shape, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params, state, batch = bundle.args
    losses = []
    for _ in range(TRAIN_WARMUP):
        params, state, met = bundle.step(params, state, batch)
        losses.append(float(met["loss"]))
    kernels.reset_launches()
    secs = []
    for _ in range(TRAIN_TIMED):
        t0 = time.perf_counter()
        params, state, met = bundle.step(params, state, batch)
        losses.append(float(met["loss"]))          # waits for the step
        secs.append(time.perf_counter() - t0)
    counts = kernels.launch_counts()
    check(all(np.isfinite(losses)), f"train: DLRM losses not finite: {losses}")
    fwd, bwd = (counts["embedding_bag"] / TRAIN_TIMED,
                counts["embedding_bag_backward"] / TRAIN_TIMED)
    check(fwd == cfg.n_sparse and bwd == cfg.n_sparse,
          f"train: {fwd} bag forward and {bwd} backward launches a step, expected "
          f"{cfg.n_sparse} each")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = float(np.median(secs))
    prof = profile_call(lambda: bundle.step(params, state, batch), sums=("bag_bwd::",))
    # every table's gradient is non-zero exactly on the rows a lookup hit
    for p in leaves(params):
        p.grad = None
    dlrm.bce_loss(params, batch["dense"], batch["sparse"], batch["labels"], cfg).backward()
    for f, t in enumerate(params["tables"]):
        hit = torch.zeros(t.shape[0], dtype=torch.bool, device=dev)
        hit[(batch["sparse"][:, f] % t.shape[0]).long()] = True
        nonzero = t.grad.abs().amax(1) > 0
        check(bool(torch.equal(nonzero, hit)),
              f"train: table {f}'s gradient is not non-zero exactly on the rows hit "
              f"({int((nonzero != hit).sum())} rows differ)")
    tables_gb = sum(t.numel() * t.element_size() for t in params["tables"]) / 1e9
    out["dlrm"] = dict(
        model=DLRM, table_rows_cap=dlrm_mlperf.TRAIN_ROW_CAP, tables_gb=tables_gb,
        batch=shape.batch, init_s=init_s, warmup_steps=TRAIN_WARMUP, steps=TRAIN_TIMED,
        median_ms=med * 1e3, min_ms=min(secs) * 1e3, max_ms=max(secs) * 1e3,
        earlier_design_median_ms=EARLIER_TRAIN_STEP_MS,
        bag_backward_device_ms=prof["ms_by_name"]["bag_bwd::"],
        model_flops=bundle.model_flops, tflops=bundle.model_flops / med / 1e12,
        losses=losses, bag_forward_launches_per_step=fwd,
        bag_backward_launches_per_step=bwd, max_memory_allocated_gb=peak_gb,
        every_table_has_its_gradient=True, profile_step=prof)
    launches = {"embedding_bag": counts["embedding_bag"],
                "embedding_bag_backward": counts["embedding_bag_backward"]}
    del bundle, params, state, batch, prof
    torch.cuda.empty_cache()

    # (2) card against CPU: tables capped at 2^16, B = 512, three steps
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 is on")
    small = dlrm_mlperf.capped(max_rows=TRAIN_CPU_CAP)
    init = dlrm.init_dlrm(small, torch.Generator().manual_seed(3), "cpu")
    batches = [steps.recsys_train_inputs(small, TRAIN_CPU_BATCH, seed=4 + i, device="cpu")
               for i in range(TRAIN_CPU_STEPS)]
    cp, cs, cl = dlrm_train_run(small, init, batches, dev)
    t0 = time.perf_counter()
    hp, hs, hl = dlrm_train_run(small, init, batches, "cpu")
    cpu_s = time.perf_counter() - t0
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(cl, hl))
    p_diff = tree_max_diff(cp, hp)
    p_top = max(float(t.detach().abs().max()) for t in leaves(hp))
    check(loss_rel <= TRAIN_TOL and p_diff <= TRAIN_TOL * p_top,
          f"train cpu_vs_card: loss rel {loss_rel}, params max |d| {p_diff} "
          f"(bar {TRAIN_TOL} x {p_top})")
    out["cpu_vs_card"] = dict(table_rows_cap=TRAIN_CPU_CAP, batch=TRAIN_CPU_BATCH,
                              steps=TRAIN_CPU_STEPS, card_losses=cl, cpu_losses=hl,
                              max_loss_rel=loss_rel, max_abs_dparam=p_diff, max_abs_param=p_top,
                              tf32=False, cpu_s=cpu_s)
    del cp, cs, hp, hs

    # (3) determinism and resume on the card
    det_batches = [steps.recsys_train_inputs(small, 8192, seed=20 + i, device="cpu")
                   for i in range(3)]
    runs = [dlrm_train_run(small, init, det_batches, dev) for _ in range(2)]
    same = tree_equal(runs[0][0], runs[1][0]) and tree_equal(runs[0][1], runs[1][1])
    check(same, "train: two identical 3-step DLRM runs differ on the card")
    straight = runs[0]
    del runs
    tmp = tempfile.mkdtemp(prefix="adacur_train_")
    try:
        crashed = []

        def step_fn(step, st):
            if step == 2 and not crashed:
                crashed.append(step)
                raise RuntimeError("a step lost at step 2")
            b = {k: v.to(dev) for k, v in det_batches[step].items()}
            p, o, _ = step_bundle.step(st["params"], st["opt"], b)
            return {"params": p, "opt": o}

        from repro_torch.configs.base import RecSysShape

        step_bundle = steps.build_recsys_train(DLRM, small, RecSysShape("train", "train", 1),
                                               params=params_copy(init, dev))
        mgr = CheckpointManager(os.path.join(tmp, "recovery"), save_every=1, keep=2)
        rec = mgr.run_with_recovery(step_fn, {"params": step_bundle.args[0],
                                              "opt": step_bundle.args[1]}, 3, device=dev)
        recovered = bool(crashed) and tree_equal(rec["params"], straight[0]) and \
            tree_equal(rec["opt"], straight[1])
        check(recovered, "train: run_with_recovery (a step raised at step 2) is not bitwise "
              "the uninterrupted run")
        del rec, step_bundle, straight
        torch.cuda.empty_cache()

        # the ce-tiny CLI: 30 steps, resumed to 50, against one 50-step run
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        cli = []
        for n, d in ((CLI_STEPS[0], "cut"), (CLI_STEPS[1], "cut"), (CLI_STEPS[1], "whole")):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                                "ce-tiny", "--steps", str(n), "--save-every", str(CLI_SAVE_EVERY),
                                "--ckpt-dir", os.path.join(tmp, d)],
                               env=env, capture_output=True, text=True, timeout=300)
            check(r.returncode == 0, f"train CLI --steps {n} failed:\n{r.stderr[-3000:]}")
            cli.append(dict(steps=n, dir=d, s=time.perf_counter() - t0,
                            resumed=f"resumed from checkpoint at step {CLI_STEPS[0]}" in r.stderr))
        check(cli[1]["resumed"], f"train CLI: the second run did not resume at step "
              f"{CLI_STEPS[0]}")
        a = os.path.join(tmp, "cut", f"step_{CLI_STEPS[1]}")
        b = os.path.join(tmp, "whole", f"step_{CLI_STEPS[1]}")
        manifest = json.load(open(os.path.join(a, "manifest.json")))["leaves"]
        np_load = lambda d, m: np.load(os.path.join(d, m["file"]))  # noqa: E731
        differ = [k for k, m in manifest.items()
                  if not np.array_equal(np_load(a, m), np_load(b, m))]
        check(not differ, f"train CLI: the resumed run's leaves differ: {differ[:5]}")
        out["determinism"] = dict(two_runs_bitwise=same, recovery_bitwise=recovered,
                                  recovery_failed_at=crashed, det_batch=8192,
                                  cli=cli, cli_leaves=len(manifest), cli_resume_bitwise=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (4) the forward-only kernels refuse autograd on the card
    out["autograd_guard"] = autograd_guard(dev)

    # (5) ce-tiny at train_4k: the largest batch (a multiple of 8) that fits
    out["ce_tiny_train_4k"] = lm_train_4k(dev, CE_TINY, LM_SHAPES["train_4k"])
    return out, launches


def autograd_guard(dev) -> dict:
    """flash_attention, approx_topk and persistent_round raise on a tensor
    that requires grad under grad mode, and run under ``torch.no_grad()``."""
    import torch

    from repro_torch.kernels.approx_topk.ops import approx_topk_op
    from repro_torch.kernels.approx_topk.persistent import persistent_round_op
    from repro_torch.kernels.flash_attention.ops import flash_attention

    q = torch.randn((2, 64, 4, 32), device=dev, requires_grad=True)
    kv = torch.randn((2, 64, 2, 32), device=dev)
    e = torch.randn((4, 64), device=dev, requires_grad=True)
    r = torch.randn((64, 4096), device=dev)
    calls = {"flash_attention": lambda: flash_attention(q, kv, kv, causal=False),
             "approx_topk": lambda: approx_topk_op(e, r, None, 8),
             "persistent_round": lambda: persistent_round_op(e, r, k_sample=8, k_prov=8)}
    raised = {}
    for name, fn in calls.items():
        try:
            fn()
            raised[name] = False
        except RuntimeError as err:
            raised[name] = "no backward" in str(err)
        with torch.no_grad():
            fn()
    torch.cuda.synchronize()
    check(all(raised.values()), f"train: a forward-only kernel took autograd inputs: {raised}")
    return raised


def lm_train_4k(dev, cfg, shape) -> dict:
    """``build_lm_train`` on ce-tiny at train_4k: the batch is the largest
    multiple of 8 whose step fits in ``LM_MEM_SHARE`` of the card, from the
    peak memory of one step at B = 1 and at B = 2 (linear in B); then one
    warm-up and three timed steps."""
    import numpy as np
    import torch

    from repro_torch.launch import steps

    def peak(b):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        bundle = steps.build_lm_train(cfg.name, cfg, shape, global_batch=b, device=dev)
        bundle.step(*bundle.args)
        torch.cuda.synchronize()
        del bundle
        return torch.cuda.max_memory_allocated()

    p1, p2 = peak(1), peak(2)
    total = torch.cuda.get_device_properties(dev).total_memory
    per = p2 - p1
    fit = int((LM_MEM_SHARE * total - (p1 - per)) // per) // 8 * 8
    check(fit >= 8, f"train: ce-tiny train_4k fits only {fit} sequences (per {per / 1e9} GB)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bundle = steps.build_lm_train(cfg.name, cfg, shape, global_batch=fit, device=dev)
    params, state, batch = bundle.args
    params, state, met = bundle.step(params, state, batch)
    losses, secs = [float(met["loss"])], []
    for _ in range(3):
        t0 = time.perf_counter()
        params, state, met = bundle.step(params, state, batch)
        losses.append(float(met["loss"]))
        secs.append(time.perf_counter() - t0)
    check(all(np.isfinite(losses)), f"train: ce-tiny losses not finite: {losses}")
    med = float(np.median(secs))
    res = dict(seq_len=shape.seq_len, reference_global_batch=shape.global_batch,
               global_batch=fit, peak_gb_b1=p1 / 1e9, peak_gb_b2=p2 / 1e9,
               card_gb=total / 1e9, median_ms=med * 1e3,
               tokens_per_s=fit * shape.seq_len / med, model_flops=bundle.model_flops,
               tflops=bundle.model_flops / med / 1e12, losses=losses,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    del bundle, params, state, batch
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the LM family at full width: prefill, decode, and the paper's pipeline
# with Qwen3-8B as the cross-encoder
# ---------------------------------------------------------------------------

LM_RUN = ("qwen3-8b", "starcoder2-3b", "granite-moe-1b-a400m", "moonshot-v1-16b-a3b")
LM_LONG = ("starcoder2-3b", "granite-moe-1b-a400m")   # long_500k fits on one card
LM_GATE_LEN = 2048        # prompt tokens of the decode == prefill and flash vs ref gates
LM_GATE_TOL = 2e-2        # the reference's own decode == encode bar (tests/test_arch_smoke.py)
LM_FP32_ROOM = 8e9        # bytes gate (a)'s fp32 run keeps free beside its weights
LM_PREFILL_MAX_B = 8      # prefill batches beyond this are cut for the phase's time
LM_DECODE_REPS = 5        # timed decode steps after a warm-up
LM_FLASH_LEN = 32768      # gate (c): prefill_32k's sequence
LM_FLASH_TAIL = 256       # its last query rows, the widest causal windows, reported apart
ADACUR_SERVE_N = 1_000_000
ADACUR_SERVE_B = 8
LM_FLOOR_FACTOR = 2.0     # a MoE model's bf16 bar: this times its one-rounding floor
CE_SCORE_ULPS = 2         # gate (d): returned score vs a direct score_tokens, bf16 ulps


def lm_bf16_rel_tol(n_layers: int) -> float:
    """The bf16 bound of gates (a) and (b) on the norm-wise relative
    difference ||x - y|| / ||y|| of two bf16 computations of one function
    at full width (hidden states or logits), once both follow the same
    routing.  They part by about one rounding a layer: in gate (b) ``ref``
    rounds the softmax probabilities to bf16 before the P V product (2^-8
    relative) where the flash kernel carries p in three bf16 terms
    (fp32-exact); in gate (a) a 1-token decode and a prefill run GEMMs of
    other shapes, whose fp32 sums round to bf16 otherwise (at most one ulp,
    2^-8 relative), and the decode's attention rounds p to bf16 where the
    prefill's flash kernel does not.  Taken as independent across layers,
    the residual stream's relative difference grows as 2^-8 x
    sqrt(n_layers); the bound is twice that."""
    return 2.0 * 2.0 ** -8 * n_layers ** 0.5


@contextlib.contextmanager
def rounding_noise(module, name: str, gen):
    """While open, every call of the attention function ``module.name``
    returns its output moved by one bf16 rounding's worth: o (1 + 2^-8 u),
    u uniform in [-1, 1) drawn from ``gen``, in fp32, cast back to o's
    dtype.  Run beside an unperturbed encode on the same routing, it
    measures how far one rounding a layer moves this model's output
    (:func:`lm_moe_bar`)."""
    import torch

    fn = getattr(module, name)

    def noisy(*a, **kw):
        o = fn(*a, **kw)
        u = torch.rand(o.shape, generator=gen, device=o.device) * 2.0 - 1.0
        return (o.float() * (1.0 + 2.0 ** -8 * u)).to(o.dtype)

    setattr(module, name, noisy)
    try:
        yield
    finally:
        setattr(module, name, fn)


def lm_moe_bar(floor: float) -> float:
    """The bf16 bound of gates (a) and (b) for a MoE model, on the same
    routing: ``LM_FLOOR_FACTOR`` x ``floor``, the model's own measured move
    under one bf16 rounding a layer (:func:`rounding_noise`).  The dense
    bound (:func:`lm_bf16_rel_tol`) assumes each layer passes a relative
    difference on about unchanged, which a MoE model does not: its gates
    re-weigh the experts, and on the H100 the MoE models' decode and
    prefill part 15x (granite) and 300x (moonshot) further than the dense
    ones' in fp32 too (norm-wise on the logits, 3.2e-5 and 6.3e-4 against
    2.0e-6 and 1.4e-6), so their sensitivity is measured rather than
    derived."""
    return LM_FLOOR_FACTOR * floor


class MoERouting:
    """Records, then replays, the experts ``moe._route`` picks, call by
    call: a model's MoE layers route in layer order in ``encode`` and in
    ``decode_step`` alike, so call i is MoE layer i.  Routing is
    discontinuous (a top-k choice flips where two experts' probabilities
    cross), so two bf16 paths that part by one rounding can route a token
    otherwise and then drift apart by far more than their rounding.
    Replaying one path's choices into the other leaves only the rounding
    to compare, and counts the flips: the (token, choice) assignments a
    replayed call's own routing would have picked instead."""

    def __init__(self):
        self.recorded, self.flips, self.assignments = [], 0, 0

    @contextlib.contextmanager
    def record(self):
        """Keep each call's experts (T, top_k)."""
        from repro_torch.models import moe

        route = moe._route

        def recording(params, x, cfg):
            top_e, top_p, aux = route(params, x, cfg)
            self.recorded.append(top_e)
            return top_e, top_p, aux

        moe._route = recording
        try:
            yield self
        finally:
            moe._route = route

    @contextlib.contextmanager
    def replay(self, first_row: int):
        """Call i takes rows ``first_row .. first_row + T`` of recorded call
        i as its experts, weighted by its own probabilities there,
        renormalised as ``_route`` does; every recorded call must be
        replayed once."""
        import torch

        from repro_torch.models import moe

        route, calls = moe._route, []

        def replaying(params, x, cfg):
            own, _, aux = route(params, x, cfg)
            top_e = self.recorded[len(calls)][first_row:first_row + x.shape[0]]
            calls.append(1)
            probs = torch.softmax(x.float() @ params["router"].float(), dim=-1)
            top_p = probs.gather(1, top_e)
            top_p = top_p / (top_p.sum(-1, keepdim=True) + 1e-9)
            self.flips += int((~(own[:, :, None] == top_e[:, None, :]).any(-1)).sum())
            self.assignments += own.numel()
            return top_e, top_p, aux

        moe._route = replaying
        try:
            yield self
        finally:
            moe._route = route
        check(len(calls) == len(self.recorded),
              f"MoE routing replay: {len(calls)} calls replayed {len(self.recorded)} recorded")


def no_drop(cfg):
    """``cfg`` with a MoE capacity factor of n_experts / top_k: every
    expert's capacity then exceeds the tokens of any call, so no
    assignment drops (a dense config is returned as it is)."""
    from repro_torch.configs.base import replace

    if cfg.moe is None:
        return cfg
    return replace(cfg, moe=replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def kv_bytes_per_token(cfg) -> int:
    return 2 * cfg.n_layers * cfg.n_kv_heads * cfg.resolved_head_dim * 2   # k and v, bf16


def tensor_bytes(tree) -> int:
    from repro_torch.tree import leaves

    return sum(t.numel() * t.element_size() for t in leaves(tree))


def lm_step_run(dev, fn, profile: bool, reps: int = 1) -> dict:
    """One profiled call of ``fn`` (wall, device-busy share) or ``reps``
    timed calls after one warm-up (median ms); peak device memory and the
    flash kernel's launches of the measured calls."""
    import numpy as np
    import torch

    from repro_torch import kernels

    if not profile:
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    res = {}
    if profile:
        prof = profile_call(fn)
        res.update(ms=prof["wall_ms"], device_busy_share=prof["device_busy_share"],
                   profile_top=prof["top"][:5])
        calls = 1
    else:
        secs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        res.update(ms=float(np.median(secs)) * 1e3, min_ms=min(secs) * 1e3)
        calls = reps
    res.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               flash_launches=kernels.launch_counts()["flash_attention"] // calls)
    return res


def lm_fp32_layers(cfg, total: float) -> int:
    """The most layers (at most the config's) whose fp32 weights fit in
    ``LM_MEM_SHARE`` of the card less ``LM_FP32_ROOM`` for the gate's
    activations: all of them but for moonshot (113.6 GB in fp32)."""
    from repro_torch.configs.base import replace

    n = cfg.n_layers
    while n > 1 and 4 * replace(cfg, n_layers=n).n_params() > LM_MEM_SHARE * total - LM_FP32_ROOM:
        n -= 1
    return n


def lm_decode_equals_prefill(dev, cfg, params, gen, routing=None) -> dict:
    """Prefill ``LM_GATE_LEN`` tokens (flash), decode token
    ``LM_GATE_LEN + 1`` into that cache, and hold its logits to the prefill
    of all ``LM_GATE_LEN + 1`` tokens at the last position, on the real
    vocab columns: in fp32 within ``LM_GATE_TOL`` (abs and rel) everywhere,
    in bf16 with a norm-wise relative difference within
    :func:`lm_bf16_rel_tol` for a dense model and within :func:`lm_moe_bar`
    for a MoE model (``ok``); both measures are reported either way.
    ``cfg`` must be :func:`no_drop` for a MoE model: capacity depends on the
    tokens of a call, so a 1-token decode and a 2,048-token prefill would
    drop differently.  With ``routing`` (a fresh :class:`MoERouting`) the
    full prefill records its routing and the shorter prefill and the decode
    replay it, so the two paths route every token alike and the flips are
    counted; the full prefill then runs again under :func:`rounding_noise`
    on the same routing, and its move is the floor of :func:`lm_moe_bar`.
    A bf16 MoE run without ``routing`` is reported, not gated (``ok``
    None)."""
    import torch

    from repro_torch.configs.base import LMShape
    from repro_torch.launch import steps
    from repro_torch.models import transformer

    n = LM_GATE_LEN
    tokens = torch.randint(4, cfg.vocab_size, (1, n + 1), generator=gen, device=dev,
                           dtype=torch.int32)
    step = steps.build_lm_prefill(cfg.name, cfg, LMShape("gate", "prefill", n, 1),
                                  params=params, device=dev).step
    record, replay = ((routing.record, routing.replay) if routing is not None
                      else (contextlib.nullcontext, lambda _: contextlib.nullcontext()))
    with record():
        ref, _ = step(params, tokens)
    with replay(0):
        _, cache = step(params, tokens[:, :n])
    full = transformer.init_cache(cfg, 1, n + 1, device=dev)
    for part in cache:
        for c, f in zip(cache[part], full[part]):
            f["k"][:, :n], f["v"][:, :n] = c["k"], c["v"]
    del cache
    with torch.no_grad(), replay(n):
        dec, _ = transformer.decode_step(params, full, tokens[:, n], n, cfg)
    v = cfg.vocab_size
    d, r = dec[:, :v].float(), ref[:, :v].float()
    err = (d - r).abs()
    outside = err > LM_GATE_TOL + LM_GATE_TOL * r.abs()
    rel = ((d - r).norm() / r.norm()).item()
    out = dict(dtype=cfg.dtype, n_layers=cfg.n_layers, prompt_len=n,
               max_abs_diff=err.max().item(), max_abs_logit=r.abs().max().item(),
               share_outside=outside.float().mean().item(), rel_norm_diff=rel,
               argmax_equal=bool(torch.equal(d.argmax(-1), r.argmax(-1))),
               capacity_factor=None if cfg.moe is None else cfg.moe.capacity_factor)
    if routing is not None:
        flips, assignments = routing.flips, routing.assignments
        with replay(0), rounding_noise(transformer, "flash_attention",
                                       torch.Generator(device=dev).manual_seed(13)):
            noisy, _ = step(params, tokens)
        floor = ((noisy[:, :v].float() - r).norm() / r.norm()).item()
        out.update(routing_replayed=True, routing_flips=flips, routing_assignments=assignments,
                   rounding_floor=floor, rel_tol=lm_moe_bar(floor))
    elif cfg.dtype == "bfloat16" and cfg.moe is None:
        out["rel_tol"] = lm_bf16_rel_tol(cfg.n_layers)
    if cfg.dtype != "bfloat16":
        out["ok"] = not bool(outside.any())
    else:
        out["ok"] = rel <= out["rel_tol"] if "rel_tol" in out else None
    return out


def lm_gate_a(dev, cfg, gen) -> dict:
    """Gate (a), decode == prefill, at full width in fp32, at the
    reference's own bar: it holds its decode to its encode in fp32
    (``smoke_config``'s dtype), and there 2e-2 measures the two paths, not
    bf16's rounding.  In bf16 any two orders of the same sums part by about
    one rounding (2^-8) a layer, which puts a few hundred of qwen3-8b's
    151,936 logits past 2e-2; :func:`lm_gate_a_bf16` holds the bf16 paths
    to the bf16 bound instead.  fp32 weights drawn on the card from the
    same seed; moonshot's depth is cut to what fits
    (:func:`lm_fp32_layers`); MoE at the no-drop capacity."""
    import torch

    from repro_torch.configs.base import replace
    from repro_torch.models import transformer

    total = torch.cuda.get_device_properties(dev).total_memory
    cfg32 = replace(no_drop(cfg), dtype="float32", n_layers=lm_fp32_layers(cfg, total))
    params = transformer.init_lm(cfg32, torch.Generator(device=dev).manual_seed(0))
    out = lm_decode_equals_prefill(dev, cfg32, params, gen)
    del params
    torch.cuda.empty_cache()
    out["depth_cut"] = None if cfg32.n_layers == cfg.n_layers else \
        f"{cfg.n_layers} -> {cfg32.n_layers}"
    return out


def lm_gate_a_bf16(dev, cfg, params) -> dict:
    """Gate (a) on the bf16 model the phase serves: decode == prefill within
    :func:`lm_bf16_rel_tol` (norm-wise, on the logits).  A MoE model's
    decode and shorter prefill replay the full prefill's routing
    (:class:`MoERouting`), and the run on their own routing is printed
    beside it (``own_routing``, not gated), with the same tokens."""
    import torch

    cfg = no_drop(cfg)

    def gen():
        return torch.Generator(device=dev).manual_seed(12)

    if cfg.moe is None:
        return lm_decode_equals_prefill(dev, cfg, params, gen())
    out = lm_decode_equals_prefill(dev, cfg, params, gen(), MoERouting())
    out["own_routing"] = lm_decode_equals_prefill(dev, cfg, params, gen())
    return out


def lm_flash_vs_ref(dev, cfg, params, gen) -> dict:
    """Gate (b): ``encode`` with ``attn_impl="flash"`` against ``"ref"`` on
    the same weights and ``LM_GATE_LEN`` tokens (no-drop capacity for a MoE
    config).  Two checks:

    - every layer of the flash encode, the kernel's output against
      ``attention_ref`` on the same q, k, v, element by element within
      2^-8 max|v| + 2^-7 max(|o_flash|, |o_ref|): ``ref``'s bf16 p is off by
      at most bf16's unit roundoff 2^-8 relative (and a sum of p_j |v_j| is
      at most max|v|), and each output is rounded to bf16 once (2^-8
      relative each);
    - the final hidden states' norm-wise relative difference within
      :func:`lm_bf16_rel_tol` for a dense model.  A MoE model's flash
      encode replays the ref encode's routing (:class:`MoERouting`, the
      flips counted) and is held within :func:`lm_moe_bar`, whose floor is
      a third, ref encode under :func:`rounding_noise` on the same routing;
      its flash encode on its own routing is printed beside it
      (``rel_norm_diff_own_routing``, not gated)."""
    import torch

    from repro_torch.models import layers, transformer

    cfg = no_drop(cfg)
    tokens = torch.randint(4, cfg.vocab_size, (1, LM_GATE_LEN), generator=gen, device=dev,
                           dtype=torch.int32)
    kernel, excess, rel_layers = transformer.flash_attention, [], []

    def both(q, k, v, **kw):
        o = kernel(q, k, v, **kw)
        of, orf = o.float(), layers.attention_ref(q, k, v, causal=kw["causal"]).float()
        bound = 2.0 ** -8 * v.float().abs().max() + 2.0 ** -7 * torch.maximum(of.abs(),
                                                                              orf.abs())
        excess.append(((of - orf).abs() - bound).max().item())
        rel_layers.append(((of - orf).norm() / orf.norm()).item())
        return o

    routing = MoERouting() if cfg.moe is not None else None
    with torch.no_grad(), (routing.record() if routing else contextlib.nullcontext()):
        hr, _ = transformer.encode(params, tokens, cfg, attn_impl="ref")
    transformer.flash_attention = both
    try:
        with torch.no_grad(), (routing.replay(0) if routing else contextlib.nullcontext()):
            hf, _ = transformer.encode(params, tokens, cfg, attn_impl="flash")
    finally:
        transformer.flash_attention = kernel
    hf, hr = hf.float(), hr.float()
    rel = ((hf - hr).norm() / hr.norm()).item()
    layers_ok = len(excess) == cfg.n_layers and max(excess) <= 0.0
    out = dict(len=LM_GATE_LEN, layers_checked=len(excess), layer_max_excess=max(excess),
               layer_max_rel_norm=max(rel_layers), layers_ok=layers_ok, rel_norm_diff=rel,
               max_abs_diff=(hf - hr).abs().max().item(), max_abs_hidden=hr.abs().max().item())
    if routing is None:
        out["tol"] = lm_bf16_rel_tol(cfg.n_layers)
    else:
        out.update(routing_replayed=True, routing_flips=routing.flips,
                   routing_assignments=routing.assignments)
        with torch.no_grad(), routing.replay(0), rounding_noise(
                layers, "attention_ref", torch.Generator(device=dev).manual_seed(14)):
            noisy, _ = transformer.encode(params, tokens, cfg, attn_impl="ref")
        floor = ((noisy.float() - hr).norm() / hr.norm()).item()
        with torch.no_grad():
            own, _ = transformer.encode(params, tokens, cfg, attn_impl="flash")
        out.update(rounding_floor=floor, tol=lm_moe_bar(floor),
                   rel_norm_diff_own_routing=((own.float() - hr).norm() / hr.norm()).item())
    out["ok"] = layers_ok and rel <= out["tol"]
    return out


def lm_fit(total: float, base: float, per: float, cap: int) -> int:
    """The largest count (<= cap) whose need ``base + n x per`` fits in
    ``LM_MEM_SHARE`` of the card (0 if none)."""
    return max(0, min(cap, int((LM_MEM_SHARE * total - base) // per)))


def lm_prefill(dev, arch, cfg, params, shape) -> dict:
    """prefill_32k at the largest batch (at most ``LM_PREFILL_MAX_B``) that
    fits in ``LM_MEM_SHARE`` of the card, found from one B = 1 step's peak
    memory (the step returns the whole KV cache); the B = 1 step is the
    warm-up, the chosen batch's step is profiled.  A model whose B = 1 step would not fit (moonshot's
    weights leave too little) prefills one sequence at the longest power-
    of-two length that fits, sized from a 2,048-token step."""
    import torch

    from repro_torch.configs.base import LMShape
    from repro_torch.launch import steps

    total = torch.cuda.get_device_properties(dev).total_memory
    base = torch.cuda.memory_allocated()
    b1 = steps.build_lm_prefill(arch, cfg, LMShape("probe", "prefill", LM_GATE_LEN, 1),
                                params=params, device=dev)
    probe = lm_step_run(dev, lambda: b1.step(*b1.args), profile=False, reps=1)
    per_tok = (probe["peak_gb"] * 1e9 - base) / LM_GATE_LEN
    out = dict(reference_global_batch=shape.global_batch, reference_seq_len=shape.seq_len)
    seq = shape.seq_len
    if base + per_tok * seq > LM_MEM_SHARE * total:
        seq = 1 << (int((LM_MEM_SHARE * total - base) // per_tok).bit_length() - 1)
        seq = min(seq, shape.seq_len)
        check(seq >= LM_GATE_LEN, f"lm: {arch} fits no {LM_GATE_LEN}-token prefill")
        b, per_seq = 1, per_tok * seq
    else:
        b1 = steps.build_lm_prefill(arch, cfg, LMShape("probe", "prefill", seq, 1),
                                    params=params, device=dev)
        probe = lm_step_run(dev, lambda: b1.step(*b1.args), profile=False, reps=1)
        per_seq = probe["peak_gb"] * 1e9 - base
        out["b1_ms"] = probe["ms"]
        b = lm_fit(total, base, per_seq, min(shape.global_batch, LM_PREFILL_MAX_B))
    del b1
    bundle = steps.build_lm_prefill(arch, cfg, LMShape(shape.name, "prefill", seq, b),
                                    params=params, global_batch=b, device=dev)
    run = lm_step_run(dev, lambda: bundle.step(*bundle.args), profile=True)
    tokens = b * seq
    out.update(batch=b, seq_len=seq, batch_cut=f"{shape.global_batch} -> {b}",
               seq_cut=None if seq == shape.seq_len else f"{shape.seq_len} -> {seq}",
               est_gb_per_seq=per_seq / 1e9, tokens_per_s=tokens / run["ms"] * 1e3,
               model_flops=bundle.model_flops,
               tflops=bundle.model_flops / run["ms"] * 1e-9, **run)
    check(run["flash_launches"] == cfg.n_layers,
          f"lm: {arch} prefill launched flash {run['flash_launches']} times, not once a layer")
    return out


def lm_decode(dev, arch, cfg, params, shape) -> dict:
    """One decode step against a cache of ``shape.seq_len`` entries at the
    largest batch that fits (from a 4,096-entry B = 1 probe: the step's own
    overhead beside the cache); a model whose B = 1 cache would not fit
    decodes one sequence at the longest cache (a multiple of 1,024) that
    does.  ``LM_DECODE_REPS`` timed steps after a warm-up, then one
    profiled."""
    import torch

    from repro_torch.configs.base import LMShape
    from repro_torch.launch import steps

    total = torch.cuda.get_device_properties(dev).total_memory
    base = torch.cuda.memory_allocated()
    kv = kv_bytes_per_token(cfg)
    probe = steps.build_lm_decode(arch, cfg, LMShape("probe", "decode", 4096, 1),
                                  params=params, device=dev)
    p = lm_step_run(dev, lambda: probe.step(*probe.args), profile=False, reps=1)
    overhead = p["peak_gb"] * 1e9 - base - kv * 4096
    del probe
    seq = shape.seq_len
    b = lm_fit(total, base + overhead, kv * seq, shape.global_batch)
    if b == 0:
        seq = int((LM_MEM_SHARE * total - base - overhead) // kv) // 1024 * 1024
        check(seq >= 4096, f"lm: {arch} fits no 4,096-entry cache")
        b = 1
    bundle = steps.build_lm_decode(arch, cfg, LMShape(shape.name, "decode", seq, b),
                                   params=params, global_batch=b, device=dev)
    run = lm_step_run(dev, lambda: bundle.step(*bundle.args), profile=False,
                      reps=LM_DECODE_REPS)
    prof = lm_step_run(dev, lambda: bundle.step(*bundle.args), profile=True)
    logits, _ = bundle.step(*bundle.args)
    check(bool(torch.isfinite(logits[:, :cfg.vocab_size].float()).all()),
          f"lm: {arch} {shape.name} logits not finite")
    moved = tensor_bytes(params) + tensor_bytes(bundle.args[1])
    del bundle, logits
    return dict(reference_global_batch=shape.global_batch, reference_seq_len=shape.seq_len,
                batch=b, seq_len=seq, batch_cut=f"{shape.global_batch} -> {b}",
                seq_cut=None if seq == shape.seq_len else f"{shape.seq_len} -> {seq}",
                cache_gb=kv * seq * b / 1e9, overhead_gb=overhead / 1e9,
                tokens_per_s=b / run["ms"] * 1e3,
                model_flops=2.0 * cfg.n_active_params() * b,
                tflops=2.0 * cfg.n_active_params() * b / run["ms"] * 1e-9,
                bytes_read_gb=moved / 1e9, read_gbps=moved / run["ms"] * 1e-6,
                device_busy_share=prof["device_busy_share"], profile_top=prof["profile_top"],
                **{k: run[k] for k in ("ms", "min_ms", "peak_gb", "flash_launches")})


def lm_adacur_serve(dev, cfg, params) -> dict:
    """The paper's pipeline with Qwen3-8B as the cross-encoder
    (``build_lm_adacur_serve`` at the reference's defaults: N = 10^6, B =
    8, items of 48 tokens, queries of 16, k_q = 500, budget 500 in 5
    rounds) on ``replace(cfg, causal=False)`` (the bidirectional CE; the
    registry's causal config would give every pair one score) and a seeded
    synthetic R_anc.  One search, each CE call timed between syncs; the
    e_q @ R_anc passes timed alone.  Gate (d): measured CE calls ==
    ``ce_call_plan`` x B; distinct ids below N; each row's scores sorted
    descending; each returned score within ``CE_SCORE_ULPS`` bf16 ulps of
    its own magnitude from a direct ``score_tokens`` of its pair, one call
    over all B x 100 returned pairs (on the H100 the difference reads 0.0:
    the CE's GEMMs give the search's batches and this one the same bits),
    so a score attached to another pair fails.  The flash kernel against
    its plain version at this path's shapes (:func:`lm_ce_flash_checks`):
    each CE call size the search made, on random q, k, v, and the first
    and last layers' own q, k, v of the direct call."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs.base import replace
    from repro_torch.core.engine import ce_call_plan
    from repro_torch.launch import steps
    from repro_torch.models import cross_encoder, layers, transformer

    ce_cfg = replace(cfg, causal=False)
    gen = torch.Generator(device=dev).manual_seed(5)
    ce_params = dict(params, score_head=layers.dense_init(gen, (cfg.d_model, 1), scale=0.02))
    bundle = steps.build_lm_adacur_serve(cfg.name, ce_cfg, params=ce_params,
                                         n_items=ADACUR_SERVE_N, batch=ADACUR_SERVE_B,
                                         device=dev)
    params_, batch_in, key = bundle.args
    plain_score = cross_encoder.score_tokens
    ce_secs, ce_sizes = [], []

    def timed_score(params, pair_tokens, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_score(params, pair_tokens, *a, **kw)
        torch.cuda.synchronize()
        ce_secs.append(time.perf_counter() - t0)
        ce_sizes.append(pair_tokens.shape[0])
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    cross_encoder.score_tokens = timed_score
    try:
        t0 = time.perf_counter()
        idx, scores = bundle.step(params_, batch_in, key)
        torch.cuda.synchronize()
        search_ms = (time.perf_counter() - t0) * 1e3
    finally:
        cross_encoder.score_tokens = plain_score
    flash = kernels.launch_counts()["flash_attention"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    acfg = steps.ADACUR_SERVE_CFG
    plan = ce_call_plan(acfg) * ADACUR_SERVE_B
    e_q = torch.randn((ADACUR_SERVE_B, batch_in["r_anc"].shape[0]), device=dev)
    eq_ms = cuda_ms(lambda: e_q @ batch_in["r_anc"], 5) * acfg.n_rounds
    pair_len = batch_in["query_tokens"].shape[1] + batch_in["corpus_tokens"].shape[1] + 3
    pairs = cross_encoder.build_pair_tokens(batch_in["query_tokens"],
                                            batch_in["corpus_tokens"][idx.long()],
                                            pad_to=pair_len).reshape(-1, pair_len)
    kernel, layer_qkv = transformer.flash_attention, []

    def keep_qkv(q, k, v, **kw):      # the first and the last layer's operands
        layer_qkv[1:] = []
        layer_qkv.append((q, k, v, kw))
        return kernel(q, k, v, **kw)

    transformer.flash_attention = keep_qkv
    try:
        with torch.no_grad():
            direct = cross_encoder.score_tokens(ce_params, pairs, ce_cfg,
                                                attn_impl="flash").reshape(idx.shape)
    finally:
        transformer.flash_attention = kernel
    diff = (direct - scores).abs()
    bar = CE_SCORE_ULPS * torch.exp2((torch.frexp(direct).exponent - 8).float())
    distinct = all(len(set(r)) == r.__len__() for r in idx.tolist())
    check(bundle.stats.ce_calls == plan,
          f"lm adacur_serve: measured CE {bundle.stats.ce_calls} != plan {plan}")
    check(distinct and int(idx.max()) < ADACUR_SERVE_N and int(idx.min()) >= 0,
          "lm adacur_serve: returned ids repeat or fall outside [0, N)")
    check(bool((scores[:, :-1] >= scores[:, 1:]).all()),
          "lm adacur_serve: a row's returned scores are not sorted descending")
    check(bool((diff <= bar).all()),
          f"lm adacur_serve: a returned score is {diff.max().item()} from its direct score "
          f"(bar {CE_SCORE_ULPS} bf16 ulps of each score)")
    flash_rows = lm_ce_flash_checks(dev, gen, cfg, pair_len, sorted(set(ce_sizes)), layer_qkv)
    del layer_qkv
    ce_ms = sum(ce_secs) * 1e3
    return dict(n_items=ADACUR_SERVE_N, batch=ADACUR_SERVE_B, k_q=batch_in["r_anc"].shape[0],
                pair_len=pair_len, causal=False, r_anc="seeded synthetic (standard normal)",
                search_ms=search_ms, ce_ms=ce_ms, ce_calls_timed=len(ce_secs),
                ce_call_ms=[s * 1e3 for s in ce_secs], rest_ms=search_ms - ce_ms,
                eq_ranc_passes_ms=eq_ms, ce_calls=bundle.stats.ce_calls, ce_plan=plan,
                ce_pairs_per_s=plan / ce_ms * 1e3,
                ce_tflops=2.0 * cfg.n_active_params() * plan * pair_len / ce_ms * 1e-9,
                ce_call_sizes=ce_sizes, model_flops=bundle.model_flops, flash_launches=flash,
                peak_gb=peak, max_score_diff=diff.max().item(), score_tol_ulps=CE_SCORE_ULPS,
                max_abs_score=scores.abs().max().item(), ids_distinct=distinct,
                flash_checks=flash_rows)


def lm_ce_flash_checks(dev, gen, cfg, pair_len, sizes, layer_qkv) -> list:
    """The flash kernel against its plain version at ``adacur_serve``'s
    shapes (non-causal bf16 pairs of ``pair_len`` tokens at ``cfg``'s
    heads), over the whole output within ``FLASH_TOL['bfloat16']``: one
    :func:`flash_case` (random q, k, v, timed beside its plain version and
    SDPA) for each CE call size in ``sizes``, and the captured
    ``layer_qkv`` (a real call's first and last layers)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain
    from repro_torch.testing import FLASH_TOL

    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    rows = [flash_case(dev, gen, 3, f"{cfg.name} CE call B={b}", b, pair_len, pair_len,
                       h, kv, hd, False, None, "bfloat16") for b in sizes]
    atol, rtol = FLASH_TOL["bfloat16"]
    for i, (q, k, v, kw) in enumerate(layer_qkv):
        kw = dict(causal=kw["causal"], kv_lens=kw["kv_lens"])
        out, ref = flash_attention(q, k, v, **kw).float(), flash_attention_plain(q, k, v, **kw)
        err = (out - ref.float()).abs()
        ok = bool((err <= atol + rtol * ref.float().abs()).all())
        name = f"{cfg.name} CE direct call B={q.shape[0]} {('first', 'last')[i]} layer"
        check(ok, f"flash_attention {name} disagrees with its plain version: max abs err "
                  f"{err.max().item()}")
        rows.append(dict(case=name, B=q.shape[0], Lq=q.shape[1], H=q.shape[2],
                         KV=k.shape[2], hd=q.shape[3], causal=kw["causal"],
                         max_abs_err=err.max().item()))
    check(len(layer_qkv) == 2, "lm adacur_serve: the direct call's layers were not captured")
    return rows


def flash_prefill_32k(dev, gen) -> dict:
    """Gate (c) and the kernel table's prefill_32k row: the flash kernel at
    Qwen3-8B's prefill_32k attention (B = 1, L = 32,768, 32/8 heads, hd 128,
    causal, bf16) against its plain version over the whole output (the
    plain version with 1,024-row tiles: its tiles shape only its own
    loops), the last ``LM_FLASH_TAIL`` query rows (the widest causal
    windows) reported apart; kernel, plain and SDPA (``is_causal``) times
    and the bound (operations)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.registry import QWEN3_8B_ATTENTION
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain
    from repro_torch.testing import FLASH_TOL

    h, kv, hd = (QWEN3_8B_ATTENTION[k] for k in ("n_heads", "n_kv_heads", "head_dim"))
    n = LM_FLASH_LEN
    q = torch.randn((1, n, h, hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((1, n, kv, hd), generator=gen, device=dev).bfloat16()
    v = torch.randn((1, n, kv, hd), generator=gen, device=dev).bfloat16()
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = flash_attention_plain(q, k, v, causal=True, block_q=1024, block_k=1024)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    atol, rtol = FLASH_TOL["bfloat16"]
    err = (out.float() - ref.float()).abs()
    ok = bool((err <= atol + rtol * ref.float().abs()).all())
    tail, max_err = err[:, -LM_FLASH_TAIL:].max().item(), err.max().item()
    check(ok, f"flash_attention at prefill_32k disagrees with its plain version: max abs err "
              f"{max_err}")
    del ref, err
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), 3)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                            enable_gqa=True), 3)
    nb, flops = flash_work(1, n, n, h, kv, hd, True, None, 2)
    b_ms, b_by = bound(nb, flops, PEAK_BF16_FLOPS)
    split_ms = bound(nb, flops * (1 + FLASH_P_TERMS) / 2, PEAK_BF16_FLOPS)[0]
    return dict(case="qwen3-8b prefill_32k", dtype="bfloat16", B=1, Lq=n, Lk=n, H=h, KV=kv,
                hd=hd, causal=True, kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, bound_split_ms=split_ms, bytes=nb, flops=flops,
                max_abs_err=max_err, tail_rows=LM_FLASH_TAIL, tail_max_abs_err=tail, ok=ok)


def phase_lm(dev):
    """The LM family at full width in bf16, seeded random weights drawn on
    the card: qwen3-8b, starcoder2-3b, granite-moe-1b-a400m and
    moonshot-v1-16b-a3b (qwen1.5-110b's 222 GB of weights need several
    cards).  Per arch: gates (a) decode == prefill (in fp32, the bf16 run
    printed) and (b) flash vs ref,
    prefill_32k and decode_32k (batch and length cut to the card),
    long_500k for the two that hold its 524,288-entry cache, and for
    qwen3-8b the paper's pipeline (gate (d)).  Gate (c), the flash kernel
    at L = 32,768, runs first.  One line an arch.  Returns (result, flash
    launches of the driven prefill and search steps)."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.configs.shapes import LM_SHAPES
    from repro_torch.models import transformer

    gen = torch.Generator(device=dev).manual_seed(11)
    out = {"flash_prefill_32k": flash_prefill_32k(dev, gen)}
    emit({"phase": "lm:flash_prefill_32k", **out["flash_prefill_32k"]})
    torch.cuda.empty_cache()
    flash = 0
    for arch in LM_RUN:
        cfg = registry.get(arch).config
        gate_a = lm_gate_a(dev, cfg, gen)
        t0 = time.perf_counter()
        params = transformer.init_lm(cfg, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        res = dict(n_params=cfg.n_params(), n_active_params=cfg.n_active_params(),
                   weights_gb=tensor_bytes(params) / 1e9, init_s=time.perf_counter() - t0,
                   decode_equals_prefill=gate_a,
                   decode_equals_prefill_bf16=lm_gate_a_bf16(dev, cfg, params))
        res["flash_vs_ref"] = lm_flash_vs_ref(dev, cfg, params, gen)
        torch.cuda.empty_cache()
        res["prefill_32k"] = lm_prefill(dev, arch, cfg, params, LM_SHAPES["prefill_32k"])
        flash += res["prefill_32k"]["flash_launches"]
        torch.cuda.empty_cache()
        res["decode_32k"] = lm_decode(dev, arch, cfg, params, LM_SHAPES["decode_32k"])
        torch.cuda.empty_cache()
        if arch in LM_LONG:
            res["long_500k"] = lm_decode(dev, arch, cfg, params, LM_SHAPES["long_500k"])
            check(res["long_500k"]["seq_len"] == LM_SHAPES["long_500k"].seq_len,
                  f"lm: {arch} long_500k did not run at its full cache")
            torch.cuda.empty_cache()
        if arch == "qwen3-8b":
            res["adacur_serve"] = lm_adacur_serve(dev, cfg, params)
            flash += res["adacur_serve"]["flash_launches"]
        del params
        torch.cuda.empty_cache()
        emit({"phase": f"lm:{arch}", **res})
        out[arch] = res
        for gate in ("decode_equals_prefill", "decode_equals_prefill_bf16", "flash_vs_ref"):
            check(res[gate]["ok"], f"lm: {arch} {gate} failed: {res[gate]}")
    out["qwen1.5-110b"] = "not run: 222 GB of bf16 weights (ROADMAP.md queue 1)"
    return out, flash


# ---------------------------------------------------------------------------
# the sharded engine: (data x items) ranks over torch.distributed on one card
# ---------------------------------------------------------------------------

SHARDED_CONFIGS = (("float32", "staged"), ("float32", "persistent"),
                   ("int8", "staged"), ("int8", "persistent"))
# one configuration also scores through the synthetic CE itself, gated
# bitwise like the others: its score_pairs gives a pair the same bits in a
# data shard's batch as in the whole batch (products and fixed-order sums)
SHARDED_SYNTHETIC = ("float32", "staged")
# two configurations also run a batch of 200 (100 rows a data shard, no
# multiple of 128): a row's estimate-state bits must not depend on its batch
SHARDED_ODD_BATCH = (("float32", "staged", 200), ("int8", "persistent", 200))
SHARDED_TIMEOUT_S = 600          # a world still running then is deadlocked: its ranks die
SHARDED_MEM_GATE = 1.1           # resident payload bytes a rank / (N / items), at most
CE_MESH = (1, 2)                 # the real-CE case's (data, items) ranks
CE_MESH_ITEMS, CE_MESH_QUERIES = 4096, 16


def sharded_cfg(payload, round_kernel, k_retrieve=100):
    from repro_torch.configs.base import AdaCURConfig

    return AdaCURConfig(k_anchor=100, n_rounds=5, budget_ce=200, strategy="topk",
                        k_retrieve=k_retrieve, loop_mode="fori", use_fused_topk=True,
                        payload_dtype=payload, round_kernel=round_kernel)


def sharded_runs():
    """(payload, round kernel, scorer, batch) of each sharded search."""
    return ([(p, k, "tabulated", 256) for p, k in SHARDED_CONFIGS]
            + [(p, k, "tabulated", b) for p, k, b in SHARDED_ODD_BATCH]
            + [(*SHARDED_SYNTHETIC, "synthetic", 256)])


def sharded_label(payload, round_kernel, scorer_kind, b) -> str:
    return f"{payload} {round_kernel} {scorer_kind} B={b}"


def sharded_qids(b, dev):
    """The serve domain's query ids of a sharded search of ``b`` rows."""
    import torch

    return torch.arange(500, 500 + b, device=dev) % 600


def timed_search(retriever, qids, key):
    """(result, ms): the second of two searches; the first warms up."""
    import torch

    retriever.search(qids, key)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = retriever.search(qids, key)
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def ce_mesh_cfg():
    """ce-tiny at full width, in fp32."""
    from repro_torch.configs.base import replace
    from repro_torch.configs.registry import CE_TINY

    return replace(CE_TINY, dtype="float32")


def ce_mesh_model(dev):
    """The real-CE mesh case's corpus and model, as ``build_real_ce_domain``
    draws them (seed 0): a ZESHEL-like corpus and ``ce_mesh_cfg``'s CE."""
    import torch

    from repro_torch.data.synthetic import make_zeshel_like
    from repro_torch.models.cross_encoder import init_cross_encoder

    cfg = ce_mesh_cfg()
    ds = make_zeshel_like(0, n_items=CE_MESH_ITEMS, n_queries=200, item_len=24, query_len=16)
    return ds, cfg, init_cross_encoder(cfg, torch.Generator().manual_seed(0), dev)


def device_ce_scorer(ds, cfg, params):
    from repro_torch.core.scorer import DeviceCEScorer

    return DeviceCEScorer(params, cfg, query_token_fn=lambda q: ds.query_tokens[q],
                          flash_block=(64, 64))


def rank_worker(kind: str, out_dir: str) -> int:
    """One rank of a world the sharded phase starts (``run_world`` gives it
    the torchrun environment); writes its results under ``out_dir``."""
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.core import prng
    from repro_torch.core.engine import AdaCURRetriever, collective_calls
    from repro_torch.core.index import AnchorIndex
    from repro_torch.core.scorer import SyntheticScorer, TabulatedScorer
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.serve import build_domain

    rank = int(os.environ["RANK"])
    out = {"rank": rank}
    if kind == "nccl_two":     # two NCCL ranks on one card: NCCL's own answer
        torch.cuda.set_device(0)
        try:
            dist.init_process_group("nccl")
            x = torch.ones(4, device="cuda")
            dist.all_reduce(x)
            torch.cuda.synchronize()
            out["error"] = None
        except Exception as e:  # noqa: BLE001 — the error text is the result
            out["error"] = f"{type(e).__name__}: {e}"
        torch.save(out, os.path.join(out_dir, f"{kind}_rank{rank}.pt"))
        os._exit(0)            # a failed communicator may not tear down cleanly
    if kind == "gloo_probe":   # which gloo collectives take CUDA tensors
        make_serving_mesh(1, int(os.environ["WORLD_SIZE"]), backend="gloo")
        dev = torch.device("cuda", torch.cuda.current_device())
        w = dist.get_world_size()
        x = torch.ones(8 * w, device=dev)
        ops = {
            "all_reduce": lambda: dist.all_reduce(x.clone()),
            "broadcast": lambda: dist.broadcast(x.clone(), src=0),
            "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(w)], x),
            "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                torch.empty(8 * w * w, device=dev), x),
            "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                torch.empty(8, device=dev), x),
            "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(x), x),
            "reduce": lambda: dist.reduce(x.clone(), dst=0),
        }
        for name, op in ops.items():
            try:
                op()
                torch.cuda.synchronize()
                out[name] = "ok"
            except Exception as e:  # noqa: BLE001 — the error text is the result
                out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
            dist.barrier()
        torch.save(out, os.path.join(out_dir, f"{kind}_rank{rank}.pt"))
        dist.destroy_process_group()
        return 0
    if kind == "ce_mesh":
        mesh = make_serving_mesh(*CE_MESH, backend="gloo")
        dev = torch.device("cuda", torch.cuda.current_device())
        ds, cfg, params = ce_mesh_model(dev)
        index = AnchorIndex.load(os.path.join(out_dir, "ce_index"), mesh=mesh)
        scorer = device_ce_scorer(ds, cfg, params)
        retriever = AdaCURRetriever.from_index(index, scorer, sharded_cfg("float32", "staged", 50))
        qids = torch.arange(100, 100 + CE_MESH_QUERIES, device=dev)
        kernels.reset_launches()
        res, ms = timed_search(retriever, qids, prng.PRNGKey(5))
        out.update(topk_idx=res.topk_idx.cpu(), rounds=res.rounds_done, ms=ms,
                   launches=kernels.launch_counts(), ce_calls=scorer.stats.ce_calls,
                   batch_pad=scorer.stats.batch_pad)
    else:                      # "sharded": the serving configuration at N = 10^6
        mesh = make_serving_mesh(*SHARDED_MESH, backend="gloo")
        dev = torch.device("cuda", torch.cuda.current_device())
        ce = build_domain(1_000_000, dev, with_index=False)[0]
        table = ce.full_matrix(torch.arange(600, device=dev))
        t0 = time.perf_counter()
        fp32 = AnchorIndex.load(os.path.join(out_dir, "index"), mesh=mesh)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        indexes = {"float32": fp32, "int8": fp32.quantize("int8")}
        torch.cuda.synchronize()
        out["quantize_s"] = time.perf_counter() - t0
        out["payload_bytes"] = {k: v.payload_nbytes for k, v in indexes.items()}
        out["local_capacity"] = {k: v.local_capacity for k, v in indexes.items()}
        for payload, round_kernel, scorer_kind, b in sharded_runs():
            scorer = TabulatedScorer(table) if scorer_kind == "tabulated" else SyntheticScorer(ce)
            retriever = AdaCURRetriever.from_index(indexes[payload], scorer,
                                                   sharded_cfg(payload, round_kernel))
            kernels.reset_launches()
            collective_calls.reset()
            res, ms = timed_search(retriever, sharded_qids(b, dev), prng.PRNGKey(5))
            counts = kernels.launch_counts()
            out[sharded_label(payload, round_kernel, scorer_kind, b)] = dict(
                collectives=collective_calls.value // 2,        # a search
                topk_idx=res.topk_idx.cpu(), topk_scores=res.topk_scores.cpu(),
                anchor_idx=res.anchor_idx.cpu(), rounds=res.rounds_done, ms=ms,
                launches=counts, ce_calls=scorer.stats.ce_calls, sharded=retriever._sharded)
    torch.save(out, os.path.join(out_dir, f"{kind}_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def start_world(kind, tmp, world, timeout=SHARDED_TIMEOUT_S) -> list:
    """Run ``world`` ranks of ``rank_worker(kind)``; every rank must exit 0
    (a rank still running at ``timeout`` is killed and fails the check)."""
    import torch

    from repro_torch.testing import run_world

    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    ranks = run_world([sys.executable, os.path.abspath(__file__), "--rank-worker", kind, tmp],
                      world, timeout, env=env)
    for r, (rc, o, e) in enumerate(ranks):
        check(rc == 0, f"sharded {kind}: rank {r} exited {rc}\n{o[-2000:]}\n{e[-4000:]}")
    return [torch.load(os.path.join(tmp, f"{kind}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


def probe_world(kind, tmp, world, timeout=120):
    """What each rank of a probe world found (a rank that hung or died is
    recorded as such: the probes' answers are findings, not gates)."""
    import torch

    from repro_torch.testing import run_world

    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    ranks = run_world([sys.executable, os.path.abspath(__file__), "--rank-worker", kind, tmp],
                      world, timeout, env=env)
    found = []
    for r, (rc, o, e) in enumerate(ranks):
        path = os.path.join(tmp, f"{kind}_rank{r}.pt")
        if os.path.exists(path):
            res = torch.load(path, weights_only=False)
            res.pop("rank")
            found.append(res)
        else:
            found.append({"exit": rc, "stderr_tail": e[-600:]})
    return found


def phase_sharded(dev, ce, index):
    """The sharded engine on one card: 2 (data) x 2 (items) gloo ranks over
    CUDA tensors load their columns of the serve domain's index (N = 10^6,
    k_q = 500), and each configuration's search (B = 256, budget 200 in 5
    rounds, fp32 and int8, staged and persistent; two also at B = 200) must
    equal the single-device engine's bit for bit; then the real-CE mesh (1 x 2),
    which gloo collectives take CUDA tensors, NCCL's answer to two ranks on
    one card, and the serve CLI under torchrun on a 1 x 1 NCCL mesh.
    Returns (result, {kernel: {payload: launches}})."""
    import shutil
    import tempfile

    import torch

    from repro_torch.core import prng
    from repro_torch.core.engine import AdaCURRetriever, ce_call_plan
    from repro_torch.core.scorer import SyntheticScorer, TabulatedScorer
    from repro_torch.kernels.approx_topk import quant
    from repro_torch.launch.serve import build_real_ce_domain
    from repro_torch.testing import topk_overlap

    tmp = tempfile.mkdtemp(prefix="adacur_sharded_")
    launches = {name: dict.fromkeys(PAYLOADS, 0) for name in ("approx_topk", "persistent_round")}
    try:
        t0 = time.perf_counter()
        index.save(os.path.join(tmp, "index"))
        save_s = time.perf_counter() - t0
        table = ce.full_matrix(torch.arange(600, device=dev))
        single = {}
        for run in sharded_runs():
            payload, round_kernel, scorer_kind, b = run
            scorer = TabulatedScorer(table) if scorer_kind == "tabulated" else SyntheticScorer(ce)
            retriever = AdaCURRetriever.from_index(index, scorer,
                                                   sharded_cfg(payload, round_kernel))
            single[sharded_label(*run)] = timed_search(retriever, sharded_qids(b, dev),
                                                       prng.PRNGKey(5))
            del retriever
        del table
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = start_world("sharded", tmp, SHARDED_MESH[0] * SHARDED_MESH[1])
        world_s = time.perf_counter() - t0
        items = SHARDED_MESH[1]
        configs, faults = [], []
        for run in sharded_runs():
            payload, round_kernel, scorer_kind, b = run
            label = sharded_label(*run)
            ref, ref_ms = single[label]
            runs = [r[label] for r in ranks]
            equal = {f: [bool(torch.equal(run[f], getattr(ref, f).cpu())) for run in runs]
                     for f in ("topk_idx", "topk_scores", "anchor_idx")}
            equal["rounds_done"] = [run["rounds"] == ref.rounds_done for run in runs]
            score_diff = max(float((run["topk_scores"] - ref.topk_scores.cpu()).abs().max())
                             for run in runs)
            anchors_moved = max(int((run["anchor_idx"] != ref.anchor_idx.cpu()).sum())
                                for run in runs)
            faults += [f"{label}: rank {r}'s {f} differs from the single-device engine's"
                       for f, per_rank in equal.items()
                       for r, ok in enumerate(per_rank) if not ok]
            faults += [f"{label}: rank {r} did not bind the sharded engine"
                       for r, run in enumerate(runs) if not run["sharded"]]
            ce_calls = sum(run["ce_calls"] for run in runs)
            plan = 2 * ce_call_plan(sharded_cfg(payload, round_kernel)) * b   # two searches
            if ce_calls != plan:
                faults.append(f"{label}: measured CE {ce_calls} != plan {plan}")
            counts = {name: sum(run["launches"][name] for run in runs) for name in launches}
            want = "approx_topk" if round_kernel == "staged" else "persistent_round"
            if not counts[want]:
                faults.append(f"{label}: {want} was never launched")
            for name in launches:
                launches[name][payload] += counts[name]
            ideal = quant.payload_nbytes(payload, index.k_q, index.n_items) / items
            ratio = max(r["payload_bytes"][payload] for r in ranks) / ideal
            if ratio > SHARDED_MEM_GATE:
                faults.append(f"{label}: a rank holds {ratio:.4f}x the ideal payload bytes")
            configs.append(dict(
                config=label, b=b, equal=equal, max_abs_score_diff=score_diff,
                anchor_entries_differing=anchors_moved,
                collectives_per_search=[run["collectives"] for run in runs],
                rounds=ref.rounds_done, sharded_ms=[run["ms"] for run in runs],
                single_device_ms=ref_ms, launches_per_rank=[run["launches"] for run in runs],
                measured_ce=ce_calls, ce_plan=plan,
                payload_bytes_per_rank=[r["payload_bytes"][payload] for r in ranks],
                ideal_bytes_per_rank=ideal, bytes_ratio=ratio,
                local_capacity=ranks[0]["local_capacity"][payload]))
        load_s = [r["load_s"] for r in ranks]
        quantize_s = [r["quantize_s"] for r in ranks]
        del ranks

        # the real CE device-resident under a 1 x 2 mesh
        cfg = ce_mesh_cfg()
        t0 = time.perf_counter()
        ds, params, host, ce_index = build_real_ce_domain(CE_MESH_ITEMS, 100, 100, cfg=cfg,
                                                          device=dev, build_micro_batch=1024)
        ce_build_s = time.perf_counter() - t0
        ce_index = ce_index.with_item_tokens(torch.as_tensor(ds.item_tokens))
        ce_index.save(os.path.join(tmp, "ce_index"))
        ce_cfg = sharded_cfg("float32", "staged", 50)
        cq = torch.arange(100, 100 + CE_MESH_QUERIES, device=dev)
        dsc = device_ce_scorer(ds, cfg, params)
        dres, dms = timed_search(AdaCURRetriever.from_index(ce_index, dsc, ce_cfg), cq,
                                 prng.PRNGKey(5))
        hres, hms = timed_search(AdaCURRetriever.from_index(ce_index, host, ce_cfg), cq,
                                 prng.PRNGKey(5))
        ce_ranks = start_world("ce_mesh", tmp, CE_MESH[0] * CE_MESH[1])
        plan = 2 * ce_call_plan(ce_cfg) * CE_MESH_QUERIES
        mesh_equal = [bool(torch.equal(run["topk_idx"], dres.topk_idx.cpu()))
                      for run in ce_ranks]
        host_equal = bool(torch.equal(dres.topk_idx, hres.topk_idx))
        faults += [f"real-CE mesh: rank {r}'s ids differ from the single-device "
                   "DeviceCEScorer's" for r, ok in enumerate(mesh_equal) if not ok]
        if not host_equal:
            faults.append("DeviceCEScorer's ids differ from CrossEncoderScorer's on one device")
        faults += [f"real-CE mesh: rank {r} launched no flash kernel"
                   for r, run in enumerate(ce_ranks) if not run["launches"]["flash_attention"]]
        ce_sum = sum(run["ce_calls"] for run in ce_ranks)
        if ce_sum != plan:
            faults.append(f"real-CE mesh: measured CE {ce_sum} != plan {plan}")
        real_ce = dict(mesh=list(CE_MESH), n_items=CE_MESH_ITEMS, b=CE_MESH_QUERIES,
                       index_build_s=ce_build_s, measured_ce=ce_sum, ce_plan=plan,
                       pad_rows_excluded=sum(run["batch_pad"] for run in ce_ranks),
                       mesh_ms=[run["ms"] for run in ce_ranks], device_ce_ms=dms,
                       cross_encoder_scorer_ms=hms, mesh_ids_equal=mesh_equal,
                       device_ce_vs_cross_encoder_ids_equal=host_equal,
                       topk_overlap_vs_cross_encoder=topk_overlap(dres.topk_idx, hres.topk_idx),
                       flash_launches_per_rank=[run["launches"]["flash_attention"]
                                                for run in ce_ranks])
        del host, ce_index, dsc, params

        probe = probe_world("gloo_probe", tmp, 2)
        nccl = probe_world("nccl_two", tmp, 2)
        cli = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             "1", "-m", "repro_torch.launch.serve", "--mesh", "1x1", "--fused",
             "--n-items", "100000", "--requests", "64", "--batch", "16"],
            env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")),
            capture_output=True, text=True, timeout=300)
        if not (cli.returncode == 0 and "served 64 requests (0 errors)" in cli.stdout
                and "measured: 12800 CE calls over 1 ranks" in cli.stdout):
            faults.append(f"NCCL 1x1 serve CLI failed:\n{cli.stdout[-2000:]}\n"
                          f"{cli.stderr[-3000:]}")
        result = dict(mesh=list(SHARDED_MESH), backend="gloo (CUDA tensors staged through "
                      "host memory), every rank on one card", n_items=index.n_items,
                      k_q=index.k_q, b=sorted({run[3] for run in sharded_runs()}),
                      save_s=save_s, world_s=world_s, load_s=load_s,
                      quantize_s=quantize_s, configs=configs, real_ce_mesh=real_ce,
                      gloo_cuda_collectives=probe, nccl_two_ranks_one_card=nccl,
                      nccl_world1_cli=[ln for ln in cli.stdout.splitlines()
                                       if "served" in ln or "measured" in ln])
        if faults:
            emit({"phase": "sharded", **result})
        check(not faults, "; ".join(faults))
        return result, launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels at small shapes only")
    ap.add_argument("--rank-worker", nargs=2, metavar=("KIND", "DIR"),
                    help=argparse.SUPPRESS)   # one rank of the sharded phase's worlds
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.rank_worker:
        return rank_worker(*args.rank_worker)
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = smi_line()
    t0 = time.perf_counter()
    probe, probe_lib = start_mma_probe_build(build)
    try:
        libs = build.build_all()
    finally:
        probe_log, _ = probe.communicate()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in info["ptxas"].splitlines()
                    if re.search(r"registers|spill|entry function|wgmma", ln)]
             for name, info in build.build_info.items()}

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    shape = (64, 128, 16384) if args.quick else (256, 500, 1_000_000)
    reps = 2 if args.quick else 3
    earlier = {} if args.quick else EARLIER_DESIGN_MS
    summary = {}
    try:
        check(probe.returncode == 0, f"the mma.sync probe did not build:\n{probe_log}")
        hgmma = sass_count(libs["flash_attention"], "HGMMA")
        emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "build_s": build_s, "ptxas": ptxas, "flash_sass_hgmma": hgmma,
              "mma_sync_tf32_tflops": mma_tf32_tflops(probe_lib)})
        spills = [ln for name in ("approx_topk", "persistent_round", "flash_attention")
                  for ln in ptxas.get(name, []) if re.search(r"[1-9][0-9]* bytes spill", ln)]
        check(not spills, f"the top-k or flash kernels spill registers: {spills}")
        check(hgmma > 0, "the bf16 flash kernel holds no HGMMA (wgmma) instruction")
        rows, errs = phase_approx_topk(shape, gen, dev, reps, earlier)
        emit({"phase": "kernel:approx_topk", "shape": shape, "cases": rows})
        for dtype in PAYLOADS:   # each payload's k = 20 row at the serving shape
            row = next(r for r in rows if r["payload"] == dtype and r["k"] == 20
                       and "case" not in r)
            summary[topk_entry("approx_topk", dtype)] = (row, errs[dtype])
        rows, errs = phase_persistent(shape, gen, dev, reps, earlier)
        emit({"phase": "kernel:persistent_round", "shape": shape, "cases": rows})
        for dtype in PAYLOADS:
            row = next(r for r in rows if r["payload"] == dtype and "case" not in r)
            summary[topk_entry("persistent_round", dtype)] = (row, errs[dtype])
        rows, err = phase_flash(gen, dev, args.quick)
        emit({"phase": "kernel:flash_attention", "cases": rows})
        summary["flash_attention"] = (rows[0], err)
        rows, err = phase_embedding_bag(gen, dev, args.quick)
        emit({"phase": "kernel:embedding_bag", "cases": rows})
        summary["embedding_bag"] = (rows[0], err)
        rows, err = phase_bag_backward(gen, dev, args.quick)
        emit({"phase": "kernel:embedding_bag_backward", "cases": rows})
        summary["embedding_bag_backward"] = (rows[0], err)
        launches = dict.fromkeys(summary, 0)
        if not args.quick:
            from repro_torch.launch.serve import build_domain

            t0 = time.perf_counter()
            ce, index = build_domain(1_000_000, dev)
            torch.cuda.synchronize()
            serve, serve_launches = phase_serve(dev, ce, index, time.perf_counter() - t0)
            emit({"phase": "serve", **serve})
            retrievers, retr_launches = phase_retrievers(dev, ce, index)
            emit({"phase": "retrievers", **retrievers})
            anytime = phase_anytime(dev, ce, index)
            emit({"phase": "anytime", **anytime})
            lifecycle, life_launches = phase_index_lifecycle(dev, ce, index)
            emit({"phase": "index_lifecycle", **lifecycle})
            router, router_launches = phase_router(dev, ce, index)
            emit({"phase": "router", **router})
            sharded, sharded_launches = phase_sharded(dev, ce, index)
            emit({"phase": "sharded", **sharded})
            del ce, index
            torch.cuda.empty_cache()
            emit({"phase": "retrievers_cpu_vs_card", "runs": phase_retrievers_cpu_vs_card(dev)})
            emit({"phase": "engine_cpu_vs_card", "runs": phase_engine_cpu_vs_card(dev)})
            real_ce, ce_launches = phase_serve_real_ce(dev)
            emit({"phase": "serve_real_ce", **real_ce})
            emit({"phase": "ce_cpu_vs_card", "runs": phase_ce_cpu_vs_card(dev)})
            from repro_torch.configs import dlrm_mlperf
            from repro_torch.launch import steps

            cfg = dlrm_mlperf.capped()
            t0 = time.perf_counter()
            params = steps.recsys_init(cfg, seed=0, device=dev)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            tables_gb = sum(t.numel() * t.element_size() for t in params["tables"]) / 1e9
            rs, rs_bags = phase_recsys_serve(dev, params, cfg)
            emit({"phase": "recsys_serve", "model": DLRM, "table_rows_cap": 1 << 24,
                  "tables_gb": tables_gb, "init_s": init_s, "steps": rs})
            rr, rr_launches = phase_recsys_retrieval(dev, params, cfg)
            emit({"phase": "recsys_retrieval", "model": DLRM, **rr})
            del params
            torch.cuda.empty_cache()
            emit({"phase": "dlrm_cpu_vs_card", **phase_dlrm_cpu_vs_card(dev)})
            train, train_launches = phase_train(dev)
            emit({"phase": "train", **train})
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            _, lm_flash = phase_lm(dev)
            emit({"phase": "lm", "seconds": time.perf_counter() - t0, "flash_launches": lm_flash})
            for name, per_payload in serve_launches.items():
                for dtype, n in per_payload.items():
                    # the serve drives, the index lifecycle's searches and
                    # every rank's sharded searches
                    launches[topk_entry(name, dtype)] = (n + life_launches[name][dtype]
                                                         + sharded_launches[name][dtype])
            launches["approx_topk"] += rr_launches["approx_topk"]     # DLRM retrieval, fp32
            # the comparison, its subset searches and the anytime drives, fp32
            launches["approx_topk"] += retr_launches["approx_topk"]
            launches["approx_topk"] += sum(run["launches"]["approx_topk"]
                                           for run in anytime.values())
            # the router's replica threads, fp32
            launches["approx_topk"] += router_launches["approx_topk"]
            launches["persistent_round"] += router_launches["persistent_round"]
            launches.update(flash_attention=ce_launches["flash_attention"]
                            + sum(sharded["real_ce_mesh"]["flash_launches_per_rank"])
                            + lm_flash,
                            embedding_bag=rs_bags + rr_launches["embedding_bag"]
                            + train_launches["embedding_bag"],
                            embedding_bag_backward=train_launches["embedding_bag_backward"])
        for name, n in launches.items():
            check(args.quick or n > 0, f"{name} was never launched on the main path")
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name.split("[")[0]],
         "replaces": REPLACES[name.split("[")[0]], "launches": launches[name],
         "max_abs_err": err, "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
         "library_ms": row["library_ms"],
         **({"payload": row["payload"]} if "payload" in row else {})}
        for name, (row, err) in summary.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
