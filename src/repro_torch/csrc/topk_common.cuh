// Shared device code of the two fused score->top-k kernels
// (approx_topk.cu, persistent_round.cu).
//
// One device function, score_tile, computes the (ROWS x TCOLS) fp32 GEMM tile
// e_q[rows] @ payload[:, cols] for both kernels, accumulating over k_q in a
// fixed ascending order with fmaf; one device function, sample_value, turns an
// accumulator into the scaled (+noise) and masked score.  Both kernels run the
// same code on the same tiles, so persistent_round equals two approx_topk
// calls bit for bit.  Scale and noise use __fmul_rn/__fadd_rn so the compiler
// cannot contract them into an FMA: the score is (acc * scale) + noise, as in
// the plain PyTorch version.
//
// Selection keeps, per (query row, block), a best-first list of k
// (value, id) pairs in shared memory, ordered by (max value, min id) and
// initialised with the sentinel (NEG_INF, INT32_MAX), which loses to every
// real candidate.  A warp owns a row: each lane holds one candidate, a
// ballot finds those that beat the list's last entry, and they are inserted
// one at a time (count of better entries = position, shift the tail).  Masked
// entries score exactly NEG_INF and still compete by id, so an under-filled
// row returns the lowest masked ids, distinct and ascending.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace adacur {

constexpr float NEG_INF_F = -1e30f;
constexpr int SENTINEL_ID = 2147483647;
constexpr int ROWS = 32;      // query rows per block
constexpr int TCOLS = 128;    // item columns per sub-tile
constexpr int KC = 16;        // k_q slice staged in shared memory per step
constexpr int THREADS = 256;  // 8 warps; a thread owns a 4 x 4 output patch
constexpr int WARPS = THREADS / 32;
constexpr int KMAX = 256;     // largest k a list may hold
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// (ROWS x TCOLS) accumulator tile for rows [row0, row0+ROWS) and columns
// [col0, col0+TCOLS) into s_acc.  Out-of-range rows/columns accumulate zeros
// and are never selected.  Ends with __syncthreads().
template <typename PT>
__device__ void score_tile(const float* __restrict__ e_q,
                           const PT* __restrict__ payload, int B, int KQ,
                           int N, int row0, int col0, float* s_eq,
                           float* s_pay, float* s_acc) {
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int q0 = 0; q0 < KQ; q0 += KC) {
    for (int t = tid; t < ROWS * KC; t += THREADS) {
      const int r = t / KC, q = t % KC;
      const int gr = row0 + r, gq = q0 + q;
      s_eq[t] = (gr < B && gq < KQ) ? e_q[(size_t)gr * KQ + gq] : 0.f;
    }
    for (int t = tid; t < KC * TCOLS; t += THREADS) {
      const int q = t / TCOLS, c = t % TCOLS;
      const int gq = q0 + q, gc = col0 + c;
      s_pay[t] = (gq < KQ && gc < N)
                     ? static_cast<float>(payload[(size_t)gq * N + gc])
                     : 0.f;
    }
    __syncthreads();
    const int qn = min(KC, KQ - q0);
    for (int q = 0; q < qn; ++q) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_eq[(ty * 4 + i) * KC + q];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = s_pay[q * TCOLS + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s_acc[(ty * 4 + i) * TCOLS + tx + 32 * j] = acc[i][j];
  __syncthreads();
}

// The score of accumulator `acc` at (row, gid): dequant scale, optional
// noise, then the n_items bound and the optional bool mask.  Anchor ids are
// checked separately (lazily, only for entries that would enter a list).
__device__ __forceinline__ float sample_value(float acc, int row, int gid,
                                              int N, int n_items,
                                              const float* __restrict__ scales,
                                              int qtile,
                                              const float* __restrict__ noise,
                                              const uint8_t* __restrict__ mask) {
  float s = acc;
  if (scales != nullptr) s = __fmul_rn(s, scales[gid / qtile]);
  if (noise != nullptr) s = __fadd_rn(s, noise[(size_t)row * N + gid]);
  bool keep = gid < n_items;
  if (mask != nullptr) keep = keep && (mask[(size_t)row * N + gid] == 0);
  return keep ? s : NEG_INF_F;
}

// Insert (v, g) into the warp's best-first list lv/li of length k, if it
// beats the last entry.  All 32 lanes call it with the same (v, g).
__device__ __forceinline__ void warp_insert(float* lv, int* li, int k, float v,
                                            int g, int lane) {
  int cnt = 0;
  for (int j = lane; j < k; j += 32) cnt += better(lv[j], li[j], v, g) ? 1 : 0;
  cnt = __reduce_add_sync(FULL, cnt);
  if (cnt >= k) return;
  float rv[KMAX / 32];
  int ri[KMAX / 32];
#pragma unroll
  for (int t = 0; t < KMAX / 32; ++t) {
    const int j = lane + 32 * t;
    if (j < k) {
      rv[t] = lv[j];
      ri[t] = li[j];
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < KMAX / 32; ++t) {
    const int j = lane + 32 * t;
    if (j >= cnt && j + 1 < k) {
      lv[j + 1] = rv[t];
      li[j + 1] = ri[t];
    }
  }
  __syncwarp();
  if (lane == 0) {
    lv[cnt] = v;
    li[cnt] = g;
  }
  __syncwarp();
}

// Offer one candidate per lane to the warp's list; `pass` lanes are those
// whose candidate beats the list's last entry (checked by the caller).
__device__ __forceinline__ void warp_offer(float* lv, int* li, int k, float v,
                                           int g, bool pass, int lane) {
  unsigned m = __ballot_sync(FULL, pass);
  while (m) {
    const int src = __ffs(m) - 1;
    const float cv = __shfl_sync(FULL, v, src);
    const int cg = __shfl_sync(FULL, g, src);
    warp_insert(lv, li, k, cv, cg, lane);
    m &= m - 1;
  }
}

__device__ __forceinline__ bool anchor_hit(const int* s_anc, int A, int gid) {
  for (int a = 0; a < A; ++a)
    if (s_anc[a] == gid) return true;
  return false;
}

// Merge per-block lists (B, M) -> (B, k) by the same rule; one warp per row.
__global__ void merge_topk_kernel(const float* __restrict__ v,
                                  const int* __restrict__ ids, int M, int k,
                                  float* __restrict__ out_v,
                                  int* __restrict__ out_i) {
  extern __shared__ unsigned char smem_raw[];
  float* lv = reinterpret_cast<float*>(smem_raw);
  int* li = reinterpret_cast<int*>(lv + k);
  const int lane = threadIdx.x;
  const size_t row = blockIdx.x;
  for (int j = lane; j < k; j += 32) {
    lv[j] = NEG_INF_F;
    li[j] = SENTINEL_ID;
  }
  __syncwarp();
  for (int base = 0; base < M; base += 32) {
    const int j = base + lane;
    const bool in = j < M;
    const float cv = in ? v[row * M + j] : NEG_INF_F;
    const int cg = in ? ids[row * M + j] : SENTINEL_ID;
    const bool pass = in && better(cv, cg, lv[k - 1], li[k - 1]);
    warp_offer(lv, li, k, cv, cg, pass, lane);
  }
  for (int j = lane; j < k; j += 32) {
    out_v[row * k + j] = lv[j];
    out_i[row * k + j] = li[j];
  }
}

}  // namespace adacur
