// Persistent ADACUR round for Hopper (sm_90a): one payload sweep feeds two
// running top-k lists.
//
// Replaces the TPU kernel _persistent_kernel
// (src/repro/kernels/approx_topk/persistent.py:232, launched by
// _persistent_pallas and persistent_round_op): each item tile is
// dequantized and multiplied once, and the product feeds
//   - the sample list: scores * scale + noise, suppressed by the anchor-id
//     list, the bool mask and n_items (k_sample entries), and
//   - the provisional list: scores * scale, suppressed by prov_mask and
//     n_items (k_prov entries),
// both merged by (max value, min id) from the sentinel (NEG_INF, INT32_MAX).
//
// Bound on an H100: as approx_topk.cu, the product at fp32 accuracy on the
// tensor cores, 1.55 ms (fp32, 3xTF32) / 0.78 ms (bf16, int8, fp8, int4:
// bf16 split) at the serving shape; the sweep does it once where the staged
// path does it twice.  The payload kinds and their decode are
// approx_topk.cu's (persistent.py:248-254 on the TPU).
//
// Design: the same kernel template as approx_topk.cu (topk_common.cuh,
// sweep_kernel<PT, 2>): the mainloop computes each accumulator fragment
// once and the same epilogue (sample_value, threshold, queue, merge) runs
// on it once per list, so each list equals the corresponding approx_topk
// call bit for bit.  The second list costs one more queue (16.8 KB of
// shared memory) and a second epilogue pass over the fragments.  The Gumbel noise
// is materialized before the launch, as the TPU path does.  A call with one
// list (k_sample or k_prov 0) is the one-list sweep, which approx_topk.cu
// compiles: the wrapper (kernels/approx_topk/persistent.py) launches it
// there, so this file holds only the five two-list instantiations.

#include "topk_common.cuh"

// As approx_topk_launch (payload kinds 0-4, logical N), with a second
// (provisional) list: ks / kp are the list lengths (both >= 1; one list is
// approx_topk_launch's sweep), prov_mask may be null; gthr_s / gthr_p are
// (B,) int32 scratch.
extern "C" int persistent_round_launch(
    const float* a_hi, const float* a_lo, const void* payload, int payload_kind,
    const float* scales, int qtile, const float* noise, const uint8_t* mask,
    const int* anchors, int A, const uint8_t* prov_mask, int B, int KQ, int N,
    int n_items, int ks, int kp, int range_cols, float* blk_sv, int* blk_si,
    float* blk_pv, int* blk_pi, int* gthr_s, int* gthr_p, float* out_sv,
    int* out_si, float* out_pv,
    int* out_pi, void* stream) {
  if (ks < 1 || kp < 1 || ks > adacur::KMAX || kp > adacur::KMAX)
    return (int)cudaErrorInvalidValue;
  const adacur::SweepArgs a = adacur::sweep_args(a_hi, a_lo, payload, scales,
                                                 qtile, B, KQ, N, n_items, range_cols);
  const adacur::ListDesc sample{noise, mask, anchors, A, ks, blk_sv, blk_si, gthr_s};
  const adacur::ListDesc prov{nullptr, prov_mask, nullptr, 0, kp, blk_pv, blk_pi, gthr_p};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* const ov[2] = {out_sv, out_pv};
  int* const oi[2] = {out_si, out_pi};
  return adacur::launch_kind<2>(payload_kind, a, sample, prov, ov, oi, s);
}
