// Fused approximate-score -> top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel _approx_topk_kernel
// (src/repro/kernels/approx_topk/kernel.py:74, launched by approx_topk_tiles
// and merged in ops.py::approx_topk_op): per item tile it computes
// e_q @ dequant(R_anc[:, tile]) * scale (+ noise), suppresses by an anchor-id
// list, a bool mask and n_items, and keeps the tile's top-k; a small merge
// selects the final k per row.
//
// Bound on an H100: the contraction is fp32 by contract (no TF32, and wgmma
// has no fp32 mode), so it runs on the CUDA cores at 67 TFLOP/s.  At the
// serving shape (B=256, k_q=500, N=10^6) that is 2.56e11 FLOP = 3.8 ms,
// against 0.6 ms (fp32) / 0.15 ms (int8) to read the payload once at
// 3.35 TB/s: operations bound it.  At small batches (B=16) bytes do.
//
// What the design does about it: the (B, N) score matrix never leaves the
// chip.  A block owns 32 query rows x one wide super-tile of columns and
// walks it in 128-column sub-tiles, staging k_q slices of e_q and of the
// payload (int8 codes widened on load) in shared memory and accumulating a
// 4x4 register patch per thread; neighbouring blocks share a super-tile, so
// the payload is re-read for each row group mostly from L2.  Each block
// writes only its (32, k) list, a few percent of the payload's bytes; a
// second kernel merges the (B, n_blocks * k) lists.  Simple first: no TMA,
// no pipelining, no tensor cores.

#include "topk_common.cuh"

namespace adacur {

template <typename PT>
__global__ void __launch_bounds__(THREADS)
approx_topk_block_kernel(const float* __restrict__ e_q,
                         const PT* __restrict__ payload,
                         const float* __restrict__ scales, int qtile,
                         const float* __restrict__ noise,
                         const uint8_t* __restrict__ mask,
                         const int* __restrict__ anchors, int A, int B, int KQ,
                         int N, int n_items, int k, int super_cols,
                         float* __restrict__ blk_v, int* __restrict__ blk_i) {
  extern __shared__ unsigned char smem_raw[];
  float* s_eq = reinterpret_cast<float*>(smem_raw);
  float* s_pay = s_eq + ROWS * KC;
  float* s_acc = s_pay + KC * TCOLS;
  float* s_lv = s_acc + ROWS * TCOLS;
  int* s_li = reinterpret_cast<int*>(s_lv + ROWS * k);
  int* s_anc = s_li + ROWS * k;

  const int row0 = blockIdx.x * ROWS;
  const int blk = blockIdx.y;
  const int nblk = gridDim.y;
  const int cbeg = blk * super_cols;
  const int cend = min(N, cbeg + super_cols);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int t = threadIdx.x; t < ROWS * k; t += THREADS) {
    s_lv[t] = NEG_INF_F;
    s_li[t] = SENTINEL_ID;
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
      float* lv = s_lv + rr * k;
      int* li = s_li + rr * k;
#pragma unroll
      for (int t = 0; t < TCOLS / 32; ++t) {
        const int c = lane + 32 * t;
        const int gid = col0 + c;
        const bool in = gid < cend;
        float v = in ? sample_value(s_acc[rr * TCOLS + c], row, gid, N, n_items,
                                    scales, qtile, noise, mask)
                     : NEG_INF_F;
        bool pass = in && better(v, gid, lv[k - 1], li[k - 1]);
        if (pass && A > 0 && anchor_hit(s_anc + rr * A, A, gid)) {
          v = NEG_INF_F;
          pass = better(v, gid, lv[k - 1], li[k - 1]);
        }
        warp_offer(lv, li, k, v, gid, pass, lane);
      }
    }
    __syncthreads();
  }

  for (int t = threadIdx.x; t < ROWS * k; t += THREADS) {
    const int r = row0 + t / k;
    if (r < B) {
      const size_t o = ((size_t)r * nblk + blk) * k + t % k;
      blk_v[o] = s_lv[t];
      blk_i[o] = s_li[t];
    }
  }
}

template <typename PT>
static int launch(const float* e_q, const PT* payload, const float* scales,
                  int qtile, const float* noise, const uint8_t* mask,
                  const int* anchors, int A, int B, int KQ, int N, int n_items,
                  int k, int super_cols, float* blk_v, int* blk_i,
                  float* out_v, int* out_i, cudaStream_t stream) {
  const int nblk = (N + super_cols - 1) / super_cols;
  const size_t smem = sizeof(float) * (ROWS * KC + KC * TCOLS + ROWS * TCOLS) +
                      (sizeof(float) + sizeof(int)) * ROWS * k +
                      sizeof(int) * ROWS * A;
  cudaFuncSetAttribute(approx_topk_block_kernel<PT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((B + ROWS - 1) / ROWS, nblk);
  approx_topk_block_kernel<PT><<<grid, THREADS, smem, stream>>>(
      e_q, payload, scales, qtile, noise, mask, anchors, A, B, KQ, N, n_items,
      k, super_cols, blk_v, blk_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_topk_kernel<<<B, 32, (sizeof(float) + sizeof(int)) * k, stream>>>(
      blk_v, blk_i, nblk * k, k, out_v, out_i);
  return (int)cudaGetLastError();
}

}  // namespace adacur

// payload_kind: 0 = fp32 (k_q, N), 1 = int8 codes (k_q, N) with per-tile
// scales.  scales / noise / mask / anchors may be null (A = 0 without
// anchors).  blk_v / blk_i hold (B, ceil(N / super_cols), k) scratch.
extern "C" int approx_topk_launch(const float* e_q, const void* payload,
                                  int payload_kind, const float* scales,
                                  int qtile, const float* noise,
                                  const uint8_t* mask, const int* anchors,
                                  int A, int B, int KQ, int N, int n_items,
                                  int k, int super_cols, float* blk_v,
                                  int* blk_i, float* out_v, int* out_i,
                                  void* stream) {
  if (k < 1 || k > adacur::KMAX || super_cols % adacur::TCOLS != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (payload_kind == 1)
    return adacur::launch<int8_t>(e_q, static_cast<const int8_t*>(payload),
                                  scales, qtile, noise, mask, anchors, A, B, KQ,
                                  N, n_items, k, super_cols, blk_v, blk_i,
                                  out_v, out_i, s);
  return adacur::launch<float>(e_q, static_cast<const float*>(payload), scales,
                               qtile, noise, mask, anchors, A, B, KQ, N,
                               n_items, k, super_cols, blk_v, blk_i, out_v,
                               out_i, s);
}
