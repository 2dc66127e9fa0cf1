// approx_topk for lists longer than KMAX = 256 (up to KMAX_LARGE = 1024):
// the dual-encoder shortlist (k = 800) and any large k.  The same sweep as
// approx_topk.cu (topk_common.cuh; its note there holds for this file),
// instantiated for lists of up to KCH_LARGE register chunks merged 256
// entries at a time (warp_merge).  It replaces the TPU kernel
// _approx_topk_kernel (src/repro/kernels/approx_topk/kernel.py:74) at those
// k.  A file of its own so that its five instantiations compile in an nvcc
// process beside approx_topk.cu's (kernels/build.py runs one a source).

#include "topk_common.cuh"

// The arguments of approx_topk.cu's approx_topk_launch; KMAX < k <= KMAX_LARGE.
extern "C" int approx_topk_large_launch(const float* a_hi, const float* a_lo,
                                        const void* payload,
                                        int payload_kind, const float* scales,
                                        int qtile, const float* noise,
                                        const uint8_t* mask, const int* anchors,
                                        int A, int B, int KQ, int N, int n_items,
                                        int k, int range_cols, float* blk_v,
                                        int* blk_i, int* gthr, float* out_v, int* out_i,
                                        void* stream) {
  if (k <= adacur::KMAX || k > adacur::KMAX_LARGE) return (int)cudaErrorInvalidValue;
  const adacur::SweepArgs a = adacur::sweep_args(a_hi, a_lo, payload, scales,
                                                 qtile, B, KQ, N, n_items, range_cols);
  const adacur::ListDesc l{noise, mask, anchors, A, k, blk_v, blk_i, gthr};
  float* const ov[2] = {out_v, nullptr};
  int* const oi[2] = {out_i, nullptr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return adacur::launch_kind<1, adacur::KCH_LARGE>(payload_kind, a, l, l, ov, oi, s);
}
