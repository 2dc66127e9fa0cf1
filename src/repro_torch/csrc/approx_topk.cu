// Fused approximate-score -> top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel _approx_topk_kernel
// (src/repro/kernels/approx_topk/kernel.py:74, launched by approx_topk_tiles
// and merged in ops.py::approx_topk_op): per item tile it computes
// e_q @ dequant(R_anc[:, tile]) * scale (+ noise), suppresses by an anchor-id
// list, a bool mask and n_items, and keeps the tile's top-k; a small merge
// selects the final k per row.
//
// Bound on an H100 at the serving shape (B=256, k_q=500, N=10^6): the
// 2.56e11 multiply-adds in 3xTF32 on the tensor cores, 3 x 2.56e11 FLOP /
// 494.7 TFLOP/s = 1.55 ms.  int8 codes are exact in TF32 and in bf16: the
// bound is three bf16 passes of an fp32 e_q split in three, 0.78 ms at
// 989 TFLOP/s (this kernel's two TF32 passes need 1.03 ms).  Both are above
// the 0.60 ms (fp32) / 0.15 ms (int8) to read the payload once at 3.35 TB/s.
//
// What the design does about it (topk_common.cuh): the product runs on the
// tensor cores (mma.sync m16n8k8 tf32, error-compensated 3xTF32 split,
// chunked fp32 accumulation), the payload and the host-split e_q chunks
// stream through a cp.async ring that overlaps loads with the mma's and
// with the epilogue, and selection works on the accumulator fragments in
// registers against a cached per-row threshold and a threshold the blocks
// publish, batching survivors into warp-parallel merges.  The (B, N) score matrix never leaves the chip: a
// block writes only its (32, k) lists, which a second kernel merges.

#include "topk_common.cuh"

// a_hi / a_lo: e_q (B, k_q) split to TF32 hi / lo in the kernels' A-fragment
// order (kernel.py::fragment_split).  payload_kind: 0 = fp32 (k_q, N),
// 1 = int8 codes (k_q, N) with per-tile
// scales.  scales / noise / mask / anchors may be null (A = 0 without
// anchors).  range_cols: columns per block (a multiple of TCOLS); blk_v /
// blk_i hold (B, ceil(N / range_cols), k) scratch, gthr (B,) int32 scratch.
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
  const int epc = payload_kind == 1 ? 16 : 4;
  const adacur::SweepArgs a{
      a_hi, a_lo, (KQ + adacur::BK - 1) / adacur::BK, payload, scales, qtile, B, KQ,
      N, n_items, range_cols,
      (reinterpret_cast<uintptr_t>(payload) % 16 == 0) && (N % epc == 0)};
  const adacur::ListDesc l{noise, mask, anchors, A, k, blk_v, blk_i, gthr};
  float* const ov[2] = {out_v, nullptr};
  int* const oi[2] = {out_i, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (payload_kind == 1) return adacur::launch_sweep<int8_t, 1>(a, l, l, ov, oi, s);
  return adacur::launch_sweep<float, 1>(a, l, l, ov, oi, s);
}
