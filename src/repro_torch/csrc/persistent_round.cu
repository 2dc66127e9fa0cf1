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
// Bound on an H100: as approx_topk.cu, the fp32 contraction on the CUDA
// cores (67 TFLOP/s) bounds it at the serving shape; the sweep does it once
// where the staged path does it twice.
//
// Design: the same tiling and the same device functions as approx_topk.cu
// (topk_common.cuh): score_tile computes the accumulator tile once, and each
// list applies sample_value to it, so each list equals the corresponding
// approx_topk call bit for bit.  Per-block lists are merged by the shared
// merge kernel.  The Gumbel noise is materialized before the launch, as the
// TPU path does.

#include "topk_common.cuh"

namespace adacur {

template <typename PT>
__global__ void __launch_bounds__(THREADS)
persistent_round_block_kernel(
    const float* __restrict__ e_q, const PT* __restrict__ payload,
    const float* __restrict__ scales, int qtile,
    const float* __restrict__ noise, const uint8_t* __restrict__ mask,
    const int* __restrict__ anchors, int A,
    const uint8_t* __restrict__ prov_mask, int B, int KQ, int N, int n_items,
    int ks, int kp, int super_cols, float* __restrict__ blk_sv,
    int* __restrict__ blk_si, float* __restrict__ blk_pv,
    int* __restrict__ blk_pi) {
  extern __shared__ unsigned char smem_raw[];
  float* s_eq = reinterpret_cast<float*>(smem_raw);
  float* s_pay = s_eq + ROWS * KC;
  float* s_acc = s_pay + KC * TCOLS;
  float* s_sv = s_acc + ROWS * TCOLS;
  int* s_si = reinterpret_cast<int*>(s_sv + ROWS * ks);
  float* s_pv = reinterpret_cast<float*>(s_si + ROWS * ks);
  int* s_pi = reinterpret_cast<int*>(s_pv + ROWS * kp);
  int* s_anc = s_pi + ROWS * kp;

  const int row0 = blockIdx.x * ROWS;
  const int blk = blockIdx.y;
  const int nblk = gridDim.y;
  const int cbeg = blk * super_cols;
  const int cend = min(N, cbeg + super_cols);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int t = threadIdx.x; t < ROWS * ks; t += THREADS) {
    s_sv[t] = NEG_INF_F;
    s_si[t] = SENTINEL_ID;
  }
  for (int t = threadIdx.x; t < ROWS * kp; t += THREADS) {
    s_pv[t] = NEG_INF_F;
    s_pi[t] = SENTINEL_ID;
  }
  for (int t = threadIdx.x; t < ROWS * A; t += THREADS) {
    const int r = row0 + t / A;
    s_anc[t] = (r < B) ? anchors[(size_t)r * A + t % A] : -1;
  }
  __syncthreads();

  for (int col0 = cbeg; col0 < cend; col0 += TCOLS) {
    score_tile<PT>(e_q, payload, B, KQ, N, row0, col0, s_eq, s_pay, s_acc);
    for (int rr = warp; rr < ROWS; rr += WARPS) {
      const int row = row0 + rr;
      if (row >= B) continue;
#pragma unroll
      for (int t = 0; t < TCOLS / 32; ++t) {
        const int c = lane + 32 * t;
        const int gid = col0 + c;
        const bool in = gid < cend;
        const float acc = s_acc[rr * TCOLS + c];
        if (ks > 0) {
          float* lv = s_sv + rr * ks;
          int* li = s_si + rr * ks;
          float v = in ? sample_value(acc, row, gid, N, n_items, scales, qtile,
                                      noise, mask)
                       : NEG_INF_F;
          bool pass = in && better(v, gid, lv[ks - 1], li[ks - 1]);
          if (pass && A > 0 && anchor_hit(s_anc + rr * A, A, gid)) {
            v = NEG_INF_F;
            pass = better(v, gid, lv[ks - 1], li[ks - 1]);
          }
          warp_offer(lv, li, ks, v, gid, pass, lane);
        }
        if (kp > 0) {
          float* lv = s_pv + rr * kp;
          int* li = s_pi + rr * kp;
          const float v = in ? sample_value(acc, row, gid, N, n_items, scales,
                                            qtile, nullptr, prov_mask)
                             : NEG_INF_F;
          const bool pass = in && better(v, gid, lv[kp - 1], li[kp - 1]);
          warp_offer(lv, li, kp, v, gid, pass, lane);
        }
      }
    }
    __syncthreads();
  }

  for (int t = threadIdx.x; t < ROWS * ks; t += THREADS) {
    const int r = row0 + t / ks;
    if (r < B) {
      const size_t o = ((size_t)r * nblk + blk) * ks + t % ks;
      blk_sv[o] = s_sv[t];
      blk_si[o] = s_si[t];
    }
  }
  for (int t = threadIdx.x; t < ROWS * kp; t += THREADS) {
    const int r = row0 + t / kp;
    if (r < B) {
      const size_t o = ((size_t)r * nblk + blk) * kp + t % kp;
      blk_pv[o] = s_pv[t];
      blk_pi[o] = s_pi[t];
    }
  }
}

template <typename PT>
static int launch(const float* e_q, const PT* payload, const float* scales,
                  int qtile, const float* noise, const uint8_t* mask,
                  const int* anchors, int A, const uint8_t* prov_mask, int B,
                  int KQ, int N, int n_items, int ks, int kp, int super_cols,
                  float* blk_sv, int* blk_si, float* blk_pv, int* blk_pi,
                  float* out_sv, int* out_si, float* out_pv, int* out_pi,
                  cudaStream_t stream) {
  const int nblk = (N + super_cols - 1) / super_cols;
  const size_t smem = sizeof(float) * (ROWS * KC + KC * TCOLS + ROWS * TCOLS) +
                      (sizeof(float) + sizeof(int)) * ROWS * (ks + kp) +
                      sizeof(int) * ROWS * A;
  cudaFuncSetAttribute(persistent_round_block_kernel<PT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((B + ROWS - 1) / ROWS, nblk);
  persistent_round_block_kernel<PT><<<grid, THREADS, smem, stream>>>(
      e_q, payload, scales, qtile, noise, mask, anchors, A, prov_mask, B, KQ,
      N, n_items, ks, kp, super_cols, blk_sv, blk_si, blk_pv, blk_pi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (ks > 0) {
    merge_topk_kernel<<<B, 32, (sizeof(float) + sizeof(int)) * ks, stream>>>(
        blk_sv, blk_si, nblk * ks, ks, out_sv, out_si);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (kp > 0) {
    merge_topk_kernel<<<B, 32, (sizeof(float) + sizeof(int)) * kp, stream>>>(
        blk_pv, blk_pi, nblk * kp, kp, out_pv, out_pi);
  }
  return (int)cudaGetLastError();
}

}  // namespace adacur

// As approx_topk_launch, with a second (provisional) list: ks / kp are the
// list lengths (0 = not requested), prov_mask may be null.
extern "C" int persistent_round_launch(
    const float* e_q, const void* payload, int payload_kind,
    const float* scales, int qtile, const float* noise, const uint8_t* mask,
    const int* anchors, int A, const uint8_t* prov_mask, int B, int KQ, int N,
    int n_items, int ks, int kp, int super_cols, float* blk_sv, int* blk_si,
    float* blk_pv, int* blk_pi, float* out_sv, int* out_si, float* out_pv,
    int* out_pi, void* stream) {
  if (ks < 0 || kp < 0 || ks > adacur::KMAX || kp > adacur::KMAX ||
      ks + kp == 0 || super_cols % adacur::TCOLS != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (payload_kind == 1)
    return adacur::launch<int8_t>(
        e_q, static_cast<const int8_t*>(payload), scales, qtile, noise, mask,
        anchors, A, prov_mask, B, KQ, N, n_items, ks, kp, super_cols, blk_sv,
        blk_si, blk_pv, blk_pi, out_sv, out_si, out_pv, out_pi, s);
  return adacur::launch<float>(
      e_q, static_cast<const float*>(payload), scales, qtile, noise, mask,
      anchors, A, prov_mask, B, KQ, N, n_items, ks, kp, super_cols, blk_sv,
      blk_si, blk_pv, blk_pi, out_sv, out_si, out_pv, out_pi, s);
}
