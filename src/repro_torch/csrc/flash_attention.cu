// Blocked online-softmax attention for Hopper (sm_90a).
//
// Replaces the TPU kernel _flash_kernel
// (src/repro/kernels/flash_attention/kernel.py:26, launched by
// flash_attention at :91): q (B, Lq, H, hd) against k, v (B, Lk, KV, hd),
// fp32 (m, l, acc) running state over key tiles, GQA (query head h reads KV
// head h / (H / KV); no KV copy in memory), the right-aligned causal mask
// (q_offset = Lk - Lq) and a per-example valid length
// limit = min(Lk, kv_lens[b]); an example of length 0 gives zeros
// (acc / (l + 1e-30) with l = acc = 0), as the Pallas kernel does.
// Two kernels, by the operands' dtype:
//
// bf16: flash_tc_kernel, on the tensor cores.
//   Bound on an H100: at the Qwen3-8B attention shape (B = 2, L = 2048,
//   32/8 heads, hd 128) operations: 1.1e11 FLOP of Q K^T and P V against
//   ~80 MB, 0.116 ms at 989 TFLOP/s (0.232 ms for the 2x work of the
//   three-term P below).  At the cross-encoder shape (L = 64, 8/4 heads, hd 32,
//   43 valid keys) bytes and the launch itself (microseconds).
//   Design:
//   - One CTA per (example, two query heads of one KV group, 64-row query
//     tile), or (example, one head, 128-row tile) when H / KV is odd: two
//     consumer warpgroups, each 64 query rows of one head.  Each K/V tile
//     staged in shared memory feeds both, so a GQA group's K/V is read
//     once per head pair, not once per head.  Causal grids walk query
//     tiles heaviest first.
//   - S = Q K^T with wgmma.mma_async m64n64k16 bf16 -> fp32, both operands
//     from shared memory, K-major: Q (loaded once) and the K tile as it
//     is stored, (key, hd) rows.
//   - Online softmax on the accumulator fragments: row max and row sum
//     over the quad of lanes that shares a row (shuffles), exp2 on
//     log2e-scaled logits, l summing the fp32 p.  Masks are applied only
//     on a tile that straddles the valid length or the causal diagonal;
//     tiles wholly past either are not visited.
//   - O += P V with p split into three bf16 terms, each the truncation to
//     bf16 of what the earlier ones leave (exact subtractions; one logic
//     op and one fadd a term, where a cvt to bf16 runs at a quarter of the
//     fp32 rate), so P carries p to 2^-21, as the Pallas kernel's fp32 p
//     needs: wgmma with A from registers (the S accumulator's layout is
//     the A fragment's) and B the V tile in shared memory, read MN-major
//     with the transpose bit.  One bf16 term misses the bf16 tolerance in
//     ~10% of outputs, two in a few per million at the cross-encoder
//     shape, where outputs are large against the tolerance's 1e-6 floor;
//     three in none (tests/test_torch_flash_attention.py holds all three).
//     That doubles the tensor-core work of attention, the kernel's price.
//     The tensor core truncates the fp32 sums it forms, so a tile's P V
//     goes into a fresh accumulator (its smallest terms first) and is
//     added to O with one rounded fma, O = O * alpha + PV; the truncation
//     spans 12 instructions, never the whole key range.
//   - Copies by TMA: thread 0 loads Q once and K/V tiles of 64 keys into a
//     4-stage ring, two tiles ahead of the one in use, through 4-d tensor
//     maps over the (B, L, heads, hd) strides (no transposed copy; rows
//     past L are zero-filled, rows in [limit, L) are read and get p = 0),
//     each stage's bytes landing on its mbarrier.  The maps swizzle as the
//     wgmma descriptors read: 128-byte rows and swizzle for hd 64 and 128
//     (hd 128 in two 64-column blocks), 64-byte for hd 32, 32-byte for
//     hd 16; every tile starts on a 1024-byte boundary.  One thread issues
//     the copies, so no warp spends its issue slots on them (per-thread
//     16-byte cp.async did, and that showed in every tile).
//   - Turns: the two warpgroups take turns at the tensor cores (two named
//     barriers), so one's softmax can run while the other's S or P V
//     products do.  The turns keep them less than a tile apart, which is
//     what lets a stage be refilled two tiles on without a CTA barrier.
//   - Epilogue: acc / (l + 1e-30) as bf16 into the contiguous
//     (B, Lq, H, hd) output.
//
// fp32: flash_fwd_kernel, on the CUDA cores, exact fp32 as the Pallas
//   kernel computes (the CE card-vs-CPU gate runs on it).  One block per
//   (batch*head, 64-row query tile), 256 threads, four per query row; K/V
//   tiles of 64 keys staged in shared memory, the online softmax in steps
//   of 16 keys, a row's dot product finished with two xor-shuffles.  At the
//   Qwen3-8B shape it is operations-bound on the CUDA cores (67 TFLOP/s).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float NEG_INF_F = -1e30f;

// ---------------------------------------------------------------- fp32 ----

constexpr int BQ = 64;                  // query rows per block
constexpr int BK = 64;                  // keys per shared-memory tile
constexpr int SUB = 16;                 // keys per online-softmax step
constexpr int LANES = 4;                // threads per query row
constexpr int THREADS = BQ * LANES;

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 const int* __restrict__ kv_lens, int H, int KV, int Lq, int Lk,
                 long long q_sb, long long q_sl, long long q_sh,
                 long long k_sb, long long k_sl, long long k_sh,
                 long long v_sb, long long v_sl, long long v_sh,
                 int causal, float scale) {
  constexpr int DPL = HD / LANES;       // dims per lane
  extern __shared__ float smem[];
  float* s_k = smem;                    // [BK][HD]
  float* s_v = smem + BK * HD;          // [BK][HD]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int g = h / (H / KV);
  const int q0 = blockIdx.y * BQ;
  const int row = threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const int qi = q0 + row;
  const int q_offset = Lk - Lq;

  int limit = Lk;
  if (kv_lens != nullptr) limit = min(limit, kv_lens[b]);
  int kend = limit;                     // keys [0, kend) can be unmasked here
  if (causal) kend = min(kend, q_offset + q0 + BQ);

  float qr[DPL], acc[DPL];
  const float* qp = q + b * q_sb + (long long)qi * q_sl + h * q_sh;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    qr[i] = qi < Lq ? qp[lane + LANES * i] : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF_F, l = 0.f;
  const float* kb = k + b * k_sb + g * k_sh;
  const float* vb = v + b * v_sb + g * v_sh;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();                    // the previous tile is consumed
    for (int e = threadIdx.x; e < BK * HD; e += THREADS) {
      const int kj = k0 + e / HD, d = e % HD;
      const bool in = kj < kend;        // later keys are masked for every row
      s_k[e] = in ? kb[kj * k_sl + d] : 0.f;
      s_v[e] = in ? vb[kj * v_sl + d] : 0.f;
    }
    __syncthreads();

    // the tile in sub-chunks of SUB keys, each an online-softmax step; a
    // sub-chunk wholly past the valid length is skipped (block-uniform)
    const int n_sub = (min(BK, kend - k0) + SUB - 1) / SUB;
#pragma unroll 1
    for (int c = 0; c < n_sub; ++c) {
      const int j0 = c * SUB;
      float s[SUB];
      float m_cur = m;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          part = fmaf(qr[i], s_k[(j0 + j) * HD + lane + LANES * i], part);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        const int kj = k0 + j0 + j;
        const bool ok = kj < limit && (!causal || kj <= q_offset + qi);
        s[j] = ok ? part * scale : NEG_INF_F;
        m_cur = fmaxf(m_cur, s[j]);
      }
      const float alpha = expf(m - m_cur);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        const int kj = k0 + j0 + j;
        const bool ok = kj < limit && (!causal || kj <= q_offset + qi);
        const float p = ok ? expf(s[j] - m_cur) : 0.f;
        psum += p;
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          acc[i] = fmaf(p, s_v[(j0 + j) * HD + lane + LANES * i], acc[i]);
      }
      l = l * alpha + psum;
      m = m_cur;
    }
  }

  if (qi < Lq) {
    float* op = out + (((long long)b * Lq + qi) * H + h) * HD;
    const float den = l + 1e-30f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) op[lane + LANES * i] = acc[i] / den;
  }
}

// ---------------------------------------------------------------- bf16 ----

namespace tc {

constexpr int BM = 64;                  // query rows of a warpgroup (wgmma M)
constexpr int BKT = 64;                 // keys of a tile (N of the S product)
constexpr int NWG = 2;                  // consumer warpgroups of a CTA
constexpr int THREADS = 128 * NWG;
constexpr int P_TERMS = 3;              // bf16 terms of p in the P V product
constexpr int STAGES = 4;               // depth of the K/V ring
constexpr int AHEAD = STAGES - 2;       // tiles in flight ahead of the one in use
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory layout of a 64-row (row, hd) bf16 tile, as TMA writes it
// and the wgmma descriptors read it: rows of ROWB bytes (hd 128 in two
// column blocks of 64 rows x 128 bytes), 16-byte chunk c of a row stored
// at chunk c ^ (address bits 7.. of the row): the hardware's 128/64/32-byte
// swizzle (MODE in the descriptor's layout field).
template <int HD>
struct Tile {
  static constexpr int ROWB = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr uint64_t MODE = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  static constexpr int BYTES = 64 * HD * 2;
  static constexpr int NBLK = HD * 2 / ROWB;                  // column blocks
  static constexpr int BOXC = ROWB / 2;                       // their width (elements)
  static constexpr int SMEM = (NWG + 2 * STAGES) * BYTES + 1024;   // + alignment

  // descriptor: start address, leading / stride byte offsets (16-byte
  // units; the stride is one 8-row group), swizzle mode
  __device__ static uint64_t desc(uint32_t addr, uint32_t lbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) |
           ((uint64_t)(8 * ROWB / 16) << 32) | (MODE << 62);
  }
  // K-major operand (Q as A, a K tile as B): head dims [16 kk, 16 kk + 16)
  __device__ static uint64_t kmajor(uint32_t tile, int kk) {
    return desc(tile + (kk * 32 / ROWB) * (64 * ROWB) + (kk * 32) % ROWB, 1);
  }
  // MN-major operand (a V tile as B): keys [16 kk, 16 kk + 16)
  __device__ static uint64_t mnmajor(uint32_t tile, int kk) {
    return desc(tile + kk * 16 * ROWB, 64 * ROWB / 16);
  }
};

// one TMA box (BOXC head dims x 64 rows of one head of one example) into
// shared memory, swizzled as the map says; the bytes land on an mbarrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
                  "r"(c3), "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}
// named barriers 1 and 2 of the CTA's 256 threads: whose turn it is to
// issue tensor-core work
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(THREADS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(THREADS) : "memory");
}
// x truncated to bf16 (its top 16 bits), held in fp32; x - trunc16(x) is
// exact.  One logic op, where a cvt to bf16 runs at a quarter of the
// fp32 rate.
__device__ __forceinline__ float trunc16(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
}
// the bf16 bits of two values truncated, packed low / high
__device__ __forceinline__ uint32_t pack_hi(float lo_half, float hi_half) {
  return __byte_perm(__float_as_uint(lo_half), __float_as_uint(hi_half), 0x7632);
}
__device__ __forceinline__ float ex2(float x) {     // 2^x, ~2 ulp; results below 2^-126 flush to 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads above wg_wait
template <int N> __device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// wgmma wrappers.  Inline PTX names every accumulator register, so the
// lists are written out.  ACC = false starts a fresh accumulator (scale-d
// 0, outputs only); ACC = true adds to it.
#define FA_D4(c, d, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define FA_D8(c, d, i) FA_D4(c, d, i), FA_D4(c, d, i + 4)
#define FA_D16(c, d, i) FA_D8(c, d, i), FA_D8(c, d, i + 8)
#define FA_D32(c, d, i) FA_D16(c, d, i), FA_D16(c, d, i + 16)
#define FA_D64(c, d, i) FA_D32(c, d, i), FA_D32(c, d, i + 32)
#define FA_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define FA_R16 FA_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define FA_R32 FA_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, " \
    "%24, %25, %26, %27, %28, %29, %30, %31"
#define FA_R64 FA_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, " \
    "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
    "%56, %57, %58, %59, %60, %61, %62, %63"

// S (m64 n64) += Q K^T over 16 head dims, A and B from shared memory,
// both K-major
#define FA_SS_N64                                                          \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                             \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" FA_R32 "}, "   \
  "%32, %33, p, 1, 1, 0, 0;\n}\n"
template <bool ACC>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (ACC)
    asm volatile(FA_SS_N64 : FA_D32("+f", d, 0) : "l"(da), "l"(db), "r"(1));
  else
    asm volatile(FA_SS_N64 : FA_D32("=f", d, 0) : "l"(da), "l"(db), "r"(0));
}

// O (m64 nN) += P V over 16 keys, A (P) from registers, B (V) from shared
// memory, MN-major (transpose bit set)
#define FA_RS(N, RL, A0, A1, A2, A3, DESC, PRED)                              \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" #PRED ", 0;\n"                        \
  "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" RL "}, "       \
  "{%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #DESC ", p, 1, 1, 1;\n}\n"
#define FA_RS_IN(a, db, acc) "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc)
#define FA_RS_FN(N, ND, DL, RL, A0, A1, A2, A3, DESC, PRED)                    \
  template <bool ACC>                                                          \
  __device__ __forceinline__ void mma_rs(float (&d)[ND], const uint32_t (&a)[4], \
                                         uint64_t db) {                        \
    if constexpr (ACC)                                                         \
      asm volatile(FA_RS(N, RL, A0, A1, A2, A3, DESC, PRED)                    \
                   : DL("+f", d, 0) : FA_RS_IN(a, db, 1));                     \
    else                                                                       \
      asm volatile(FA_RS(N, RL, A0, A1, A2, A3, DESC, PRED)                    \
                   : DL("=f", d, 0) : FA_RS_IN(a, db, 0));                     \
  }
FA_RS_FN(16, 8, FA_D8, FA_R8, 8, 9, 10, 11, 12, 13)
FA_RS_FN(32, 16, FA_D16, FA_R16, 16, 17, 18, 19, 20, 21)
FA_RS_FN(64, 32, FA_D32, FA_R32, 32, 33, 34, 35, 36, 37)
FA_RS_FN(128, 64, FA_D64, FA_R64, 64, 65, 66, 67, 68, 69)

template <int HD>
__global__ void __launch_bounds__(THREADS, HD <= 32 ? 2 : 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                const int* __restrict__ kv_lens, int H, int KV, int Lq, int Lk, int causal,
                float scale) {
  using T = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t skv = sq + NWG * T::BYTES;       // STAGES x (K tile, V tile)

  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int rep = H / KV;
  const int hpc = rep % 2 == 0 ? 2 : 1;           // query heads of a CTA
  const int spc = NWG / hpc;                      // 64-row slices of a CTA
  const int b = blockIdx.x / (H / hpc);
  const int h0 = (blockIdx.x % (H / hpc)) * hpc;
  const int grp = h0 / rep;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;   // heaviest first
  const int q0 = qt * BM * spc;
  const int h = h0 + wg / spc;                    // this warpgroup's head
  const int qw = q0 + (wg % spc) * BM;            // and its first query row
  const int q_offset = Lk - Lq;

  int limit = Lk;
  if (kv_lens != nullptr) limit = min(limit, kv_lens[b]);
  int kend = limit;                               // keys some row of the CTA sees
  if (causal) kend = min(kend, q_offset + min(q0 + BM * spc, Lq));
  const int n_tiles = kend > 0 ? (kend + BKT - 1) / BKT : 0;
  int wend = qw < Lq ? limit : 0;                 // keys some row of the warpgroup sees
  if (causal) wend = min(wend, q_offset + min(qw + BM, Lq));

  __shared__ uint64_t full_bar[STAGES];          // a K/V stage has landed
  const uint32_t full0 = static_cast<uint32_t>(__cvta_generic_to_shared(full_bar));
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(full0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 copies tile t (and Q with tile 0) by TMA; rows past Lk (and Q
  // rows past Lq) are zero-filled, rows in [limit, Lk) are read and get p = 0
  auto issue = [&](int t) {
    const uint32_t bar = full0 + 8 * (t % STAGES);
    const uint32_t sk = skv + (t % STAGES) * 2 * T::BYTES, sv = sk + T::BYTES;
    mbar_expect(bar, 2 * T::BYTES + (t == 0 ? NWG * T::BYTES : 0));
    if (t == 0)
      for (int w = 0; w < NWG; ++w)
        for (int cb = 0; cb < T::NBLK; ++cb)
          tma_load(sq + w * T::BYTES + cb * 64 * T::ROWB, &tq, cb * T::BOXC, h0 + w / spc,
                   q0 + (w % spc) * BM, b, bar);
    for (int cb = 0; cb < T::NBLK; ++cb) {
      tma_load(sk + cb * 64 * T::ROWB, &tk, cb * T::BOXC, grp, t * BKT, b, bar);
      tma_load(sv + cb * 64 * T::ROWB, &tv, cb * T::BOXC, grp, t * BKT, b, bar);
    }
  };
  if (tid == 0)
    for (int t = 0; t < AHEAD && t < n_tiles; ++t) issue(t);

  const float sl2 = scale * LOG2E;
  const int r0 = qw + warp * 16 + lane / 4;       // rows of the fragments: r0, r0 + 8
  const int c0 = (lane % 4) * 2;                  // first column in each 8-column block
  const uint32_t qtile = sq + wg * T::BYTES;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF_F, NEG_INF_F}, l[2] = {0.f, 0.f};

  // The two warpgroups take turns at the tensor cores (named barrier 1 + wg
  // is warpgroup wg's turn), two turns a tile: S, then P V.  The turns keep
  // them less than a tile apart, so thread 0 refills a stage AHEAD tiles on
  // once both have finished the tile it held.
  const int mine = 1 + wg, theirs = 2 - wg;
  if (wg == 1) bar_arrive(1);                     // warpgroup 0 starts
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(full0 + 8 * (t % STAGES), (t / STAGES) & 1);
    const int k0 = t * BKT;
    if (k0 >= wend) {                             // no row of this warpgroup sees the tile
      if (tid == 0 && t + AHEAD < n_tiles) issue(t + AHEAD);
      __syncwarp();
      bar_sync(mine);
      bar_arrive(theirs);
      bar_sync(mine);
      bar_arrive(theirs);
      continue;
    }
    const uint32_t sk = skv + (t % STAGES) * 2 * T::BYTES, sv = sk + T::BYTES;

    float s[BKT / 2];
    bar_sync(mine);
    wg_fence();
    mma_ss<false>(s, T::kmajor(qtile, 0), T::kmajor(sk, 0));
#pragma unroll
    for (int kk = 1; kk < HD / 16; ++kk) mma_ss<true>(s, T::kmajor(qtile, kk), T::kmajor(sk, kk));
    wg_commit();
    bar_arrive(theirs);
    if (tid == 0 && t + AHEAD < n_tiles) issue(t + AHEAD);   // while S runs
    __syncwarp();
    wg_wait();
    keep(s);

    // s[4 i + e]: row r0 + 8 (e / 2), key k0 + 8 i + c0 + e % 2
    const bool edge = k0 + BKT > limit || (causal && k0 + BKT - 1 > q_offset + qw);
    if (edge) {
#pragma unroll
      for (int i = 0; i < BKT / 2; ++i) {
        const int kj = k0 + (i / 4) * 8 + c0 + (i & 1);
        const int qi = r0 + ((i >> 1) & 1) * 8;
        if (kj >= limit || (causal && kj > q_offset + qi)) s[i] = NEG_INF_F;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BKT / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2((m[r] - mx[r]) * sl2);
      mb[r] = mx[r] * sl2;
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    // p in fp32 for l; its three bf16 terms, each the truncation of what
    // the earlier ones leave (exact subtractions; p to 2^-21), packed as
    // the P V product's A fragments
    uint32_t pa[P_TERMS][BKT / 16][4];
#pragma unroll
    for (int i = 0; i < BKT / 2; i += 2) {
      const int r = (i >> 1) & 1;
      float p0 = ex2(fmaf(s[i], sl2, -mb[r]));
      float p1 = ex2(fmaf(s[i + 1], sl2, -mb[r]));
      if (edge) {
        if (s[i] == NEG_INF_F) p0 = 0.f;
        if (s[i + 1] == NEG_INF_F) p1 = 0.f;
      }
      l[r] += p0 + p1;
#pragma unroll
      for (int j = 0; j < P_TERMS; ++j) {
        pa[j][i / 8][(i % 8) / 2] = pack_hi(p0, p1);
        p0 -= trunc16(p0);
        p1 -= trunc16(p1);
      }
    }

    float pv[HD / 2];                             // this tile's P V, smallest terms first
    bar_sync(mine);
    wg_fence();
    mma_rs<false>(pv, pa[P_TERMS - 1][0], T::mnmajor(sv, 0));
#pragma unroll
    for (int kk = 1; kk < BKT / 16; ++kk)
      mma_rs<true>(pv, pa[P_TERMS - 1][kk], T::mnmajor(sv, kk));
#pragma unroll
    for (int j = P_TERMS - 2; j >= 0; --j)
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk) mma_rs<true>(pv, pa[j][kk], T::mnmajor(sv, kk));
    wg_commit();
    bar_arrive(theirs);
    wg_wait();
    keep(pv);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], pv[i]);
  }
  if (wg == 0) bar_sync(1);                       // warpgroup 1's last turn is over

  if (qw >= Lq) return;
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = l[r];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    den[r] = x + 1e-30f;
  }
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + 8 * r;
      if (qi < Lq)
        *reinterpret_cast<__nv_bfloat162*>(out + (((long long)b * Lq + qi) * H + h) * HD +
                                           i * 8 + c0) =
            __floats2bfloat162_rn(o[4 * i + 2 * r] / den[r], o[4 * i + 2 * r + 1] / den[r]);
    }
}

}  // namespace tc

static int set_smem(const void* fn, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int HD>
static int launch_fp32(const void* q, const void* k, const void* v, void* out,
                       const int* kv_lens, int B, int Lq, int Lk, int H, int KV,
                       const long long* st, int causal, float scale, cudaStream_t stream) {
  const int smem = 2 * BK * HD * (int)sizeof(float);
  if (int err = set_smem((const void*)flash_fwd_kernel<HD>, smem)) return err;
  dim3 grid(B * H, (Lq + BQ - 1) / BQ);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  flash_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), kv_lens, H, KV, Lq, Lk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, scale);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled (libcuda), looked up at run time through the
// CUDA runtime, so the library needs no link against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (B, L, heads, hd) bf16 operand as a 4-d TMA map {hd, heads, L, B}
// (strides in elements, multiples of 8), boxes of BOXC head dims x 64 rows
template <int HD>
static int tensor_map(CUtensorMap* map, const void* base, int B, int L, int heads,
                      long long s_b, long long s_l, long long s_h) {
  using T = tc::Tile<HD>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_h * 2, (cuuint64_t)s_l * 2, (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)T::BOXC, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = T::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : T::ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
static int launch_bf16(const void* q, const void* k, const void* v, void* out,
                       const int* kv_lens, int B, int Lq, int Lk, int H, int KV,
                       const long long* st, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (int err = tensor_map<HD>(&tq, q, B, Lq, H, st[0], st[1], st[2])) return err;
  if (int err = tensor_map<HD>(&tk, k, B, Lk, KV, st[3], st[4], st[5])) return err;
  if (int err = tensor_map<HD>(&tv, v, B, Lk, KV, st[6], st[7], st[8])) return err;
  const int smem = tc::Tile<HD>::SMEM;
  if (int err = set_smem((const void*)tc::flash_tc_kernel<HD>, smem)) return err;
  const int hpc = (H / KV) % 2 == 0 ? 2 : 1;
  const int rows = tc::BM * (tc::NWG / hpc);
  dim3 grid(B * (H / hpc), (Lq + rows - 1) / rows);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  tc::flash_tc_kernel<HD><<<grid, tc::THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), kv_lens, H, KV, Lq, Lk, causal, scale);
  return (int)cudaGetLastError();
}

template <int HD>
static int launch(int dtype, const void* q, const void* k, const void* v, void* out,
                  const int* kv_lens, int B, int Lq, int Lk, int H, int KV,
                  const long long* st, int causal, float scale, cudaStream_t s) {
  return dtype == 1
      ? launch_bf16<HD>(q, k, v, out, kv_lens, B, Lq, Lk, H, KV, st, causal, scale, s)
      : launch_fp32<HD>(q, k, v, out, kv_lens, B, Lq, Lk, H, KV, st, causal, scale, s);
}

}  // namespace flash

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel;
// q, k and v base pointers and strides must be 16-byte aligned for
// cp.async).  q, k, v and out share the dtype.  Strides are in elements,
// for the batch, sequence and head axes (the last axis is contiguous); out
// is a contiguous (B, Lq, H, hd) tensor.  kv_lens may be null (every
// example is Lk long).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, const int* kv_lens,
    int dtype, int B, int Lq, int Lk, int H, int KV, int hd, long long q_sb,
    long long q_sl, long long q_sh, long long k_sb, long long k_sl,
    long long k_sh, long long v_sb, long long v_sl, long long v_sh, int causal,
    float scale, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || KV < 1 || H % KV != 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return flash::launch<16>(dtype, q, k, v, out, kv_lens, B, Lq, Lk, H, KV, st, causal, scale, s);
    case 32: return flash::launch<32>(dtype, q, k, v, out, kv_lens, B, Lq, Lk, H, KV, st, causal, scale, s);
    case 64: return flash::launch<64>(dtype, q, k, v, out, kv_lens, B, Lq, Lk, H, KV, st, causal, scale, s);
    case 128: return flash::launch<128>(dtype, q, k, v, out, kv_lens, B, Lq, Lk, H, KV, st, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
