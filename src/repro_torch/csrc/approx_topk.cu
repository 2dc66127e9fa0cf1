// Fused approximate-score -> top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel _approx_topk_kernel
// (src/repro/kernels/approx_topk/kernel.py:74, launched by approx_topk_tiles
// and merged in ops.py::approx_topk_op): per item tile it computes
// e_q @ dequant(R_anc[:, tile]) * scale (+ noise), suppresses by an anchor-id
// list, a bool mask and n_items, and keeps the tile's top-k; a small merge
// selects the final k per row.  R_anc is fp32, bf16, or int8 / fp8 e4m3 /
// packed int4 codes with per-tile scales, decoded in registers as the TPU
// kernel does in its body (kernel.py:100-107).
//
// Bound on an H100 at the serving shape (B=256, k_q=500, N=10^6): the
// 2.56e11 multiply-adds in 3xTF32 on the tensor cores, 3 x 2.56e11 FLOP /
// 494.7 TFLOP/s = 1.55 ms.  bf16 values and int8 / fp8 / int4 codes are
// exact in TF32 and in bf16: the bound is three bf16 passes of an fp32 e_q
// split in three, 0.78 ms at 989 TFLOP/s (this kernel's two TF32 passes
// need 1.03 ms).  Both are above the time to read the payload once at
// 3.35 TB/s: 0.60 ms (fp32), 0.30 (bf16), 0.15 (int8, fp8), 0.075 (int4).
//
// What the design does about it (topk_common.cuh): the product runs on the
// tensor cores (mma.sync m16n8k8 tf32, error-compensated 3xTF32 split,
// chunked fp32 accumulation), the payload and the host-split e_q chunks
// stream through a cp.async ring that overlaps loads with the mma's and
// with the epilogue, and selection works on the accumulator fragments in
// registers against a cached per-row threshold and a threshold the blocks
// publish, batching survivors into warp-parallel merges.  Lists longer than
// KMAX = 256 (the dual-encoder shortlist of k = 800, up to 1024) take a
// second instantiation that merges a list 256 entries at a time, so the
// k <= 256 kernel keeps its registers and code.  The (B, N) score matrix never leaves the chip: a
// block writes only its (32, k) lists, which a second kernel merges.

#include "topk_common.cuh"

// a_hi / a_lo: e_q (B, k_q) split to TF32 hi / lo in the kernels' A-fragment
// order (kernel.py::fragment_split).  payload_kind (adacur::PayloadKind):
// 0 = fp32 (k_q, N), 1 = int8 codes (k_q, N), 2 = bf16 (k_q, N), 3 = fp8
// e4m3 codes (k_q, N), 4 = packed int4 codes (k_q, ceil(N / 2)) bytes; the
// coded kinds 1, 3, 4 carry per-tile scales.  N is the logical item count.
// scales / noise / mask / anchors may be null (A = 0 without anchors).
// range_cols: columns per block (a multiple of TCOLS); blk_v / blk_i hold
// (B, ceil(N / range_cols), k) scratch, gthr (B,) int32 scratch.
// 1 <= k <= KMAX (256): the sweep whose lists are read in one register
// chunk (the serving path's kernel).  A larger k, up to KMAX_LARGE (1024),
// is approx_topk_large.cu's approx_topk_large_launch, the same sweep
// instantiated for lists of up to four chunks (warp_merge): a file of its
// own, so its five instantiations compile in an nvcc beside this one's.
extern "C" int approx_topk_launch(const float* a_hi, const float* a_lo,
                                  const void* payload,
                                  int payload_kind, const float* scales,
                                  int qtile, const float* noise,
                                  const uint8_t* mask, const int* anchors,
                                  int A, int B, int KQ, int N, int n_items,
                                  int k, int range_cols, float* blk_v,
                                  int* blk_i, int* gthr, float* out_v, int* out_i,
                                  void* stream) {
  if (k < 1 || k > adacur::KMAX) return (int)cudaErrorInvalidValue;
  const adacur::SweepArgs a = adacur::sweep_args(a_hi, a_lo, payload, scales,
                                                 qtile, B, KQ, N, n_items, range_cols);
  const adacur::ListDesc l{noise, mask, anchors, A, k, blk_v, blk_i, gthr};
  float* const ov[2] = {out_v, nullptr};
  int* const oi[2] = {out_i, nullptr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return adacur::launch_kind<1>(payload_kind, a, l, l, ov, oi, s);
}
