// Shared device core of the two fused score->top-k kernels
// (approx_topk.cu, persistent_round.cu), redesigned for Hopper (sm_90a).
//
// Both kernels are one template, sweep_kernel<K, NL>: NL = 1 list for
// approx_topk (port of _approx_topk_kernel,
// src/repro/kernels/approx_topk/kernel.py:74), NL = 2 lists for
// persistent_round (port of _persistent_kernel,
// src/repro/kernels/approx_topk/persistent.py:232).  One mainloop computes
// each accumulator once; one epilogue value function (sample_value) turns
// it into each list's score.  So persistent_round equals two approx_topk
// calls bit for bit.
//
// Bound (H100 SXM, B=256, k_q=500, N=10^6): 2.56e11 multiply-adds.  In
// 3xTF32 on the tensor cores that is 3 x 2.56e11 FLOP / 494.7 TFLOP/s =
// 1.55 ms for an fp32 payload.  bf16 values, int8 and fp8 e4m3 codes and
// int4 nibbles are all exact in TF32 (and in bf16): two TF32 passes take
// 1.03 ms, three bf16 passes of a three-way split e_q 0.78 ms at 989
// TFLOP/s, the bound.  All are above the time to read the payload once at
// 3.35 TB/s: 0.60 ms (fp32), 0.30 ms (bf16), 0.15 ms (int8, fp8), 0.075 ms
// (packed int4).  The CUDA-core fp32 figure is 3.82 ms at 67 TFLOP/s.
//
// Payloads (the port of the TPU kernels' in-body decode, kernel.py:100-107,
// persistent.py:248-254): a tag, PayloadKind, names what a stored element
// is, and Payload<K> says how it is staged and decoded; nothing branches on
// sizeof, so fp8 bytes are never read as int8 codes.  Each kind decodes in
// registers, at the B-fragment load, to an exact TF32 value that feeds the
// same two-pass mainloop (a_lo*b + a_hi*b, no b_lo part):
//   int8  the code biased by 128, put in the mantissa of 2^23, minus 2^23 + 128;
//   int4  the nibble biased by 8 (x ^ 8), the same trick minus 2^23 + 8;
//   bf16  its bits shifted up 16;
//   fp8   sign to bit 31, the 7 exponent/mantissa bits to bits 20..26, times
//         2^120: exact for normals, subnormals (an fp32 subnormal times a
//         power of two; no flush to zero in this build), +-0 and +-448.
// The per-tile scale of the coded kinds multiplies the finished
// accumulator (sample_value), as for int8.  The ring stage holds a tile's
// rows as stored: a packed int4 row is TCOLS / 2 bytes, and a lane reads
// its four columns 32 grp + 4g .. +3 as one 2-byte load.  Widening the
// stage to int8 after the cp.async lands would cost a pass over shared
// memory and a barrier a stage for no fewer loads (int8 also reads one
// word a group), so the packed layout stays; the row pad (16 bytes, 4
// words mod 32) keeps the four t rows of a warp's 2-byte loads on distinct
// banks, as the 8-word pads do for the 4-, 8- and 16-byte loads.
//
// Design:
// 1. Mainloop on the tensor cores, 3xTF32.  Each fp32 operand x splits
//    into hi = tf32(x) and lo = tf32(x - hi), rounded to nearest, ties
//    away (cvt.rna's rounding, done on the integer pipes); per chunk of
//    BK = 32 of k_q the accumulator takes every a_lo*b_hi and a_hi*b_lo
//    first, then the a_hi*b_hi (small terms first, so the tensor core's
//    truncation of its fp32 sums hits them at a small scale) with
//    mma.sync.m16n8k8 tf32.  bf16 values and int8 / fp8 / int4 codes are
//    exact in TF32, so b_lo = 0 and two passes do.  The tensor core adds in
//    a chunk accumulator that restarts every BK = 32 of k_q; each chunk is
//    added to the running fp32 sum with __fadd_rn, so the hardware's
//    truncating accumulation only ever spans 32 terms.  For every payload
//    that add's rounding error (Fast2Sum) is where the next chunk's
//    accumulator starts, so the running sum is not rounded at its own
//    scale once a chunk, and the tensor core's truncation (most of its
//    sums are the exact sum of c and a k-step's 8 products, truncated
//    toward zero; ref.tf32x3_scores(truncate=True) replays it) sets the
//    error alone.  The carry costs two adds an accumulator a chunk (fp32
//    k = 20 about +6%, PERF.md, the kernel table); without it fp32's worst
//    near-full error reached 1.33x cuBLAS fp32's over seeds 0-7.
//    mma.sync and not wgmma: wgmma transposes only 16-bit operands, and
//    R_anc is (k_q, N) row-major (N contiguous), so the payload tile
//    would have to be transposed to K-major in shared memory first.  That
//    is the next step if mma.sync tops out.
// 2. Asynchronous copies.  A block owns ROWS = 32 query rows and one
//    column range; a warp owns a 32 x 64 tile of it (2 m16 x 8 n8 mma
//    tiles, at most 255 registers, no spill).  A double buffer in shared
//    memory holds, per BK chunk of k_q, one (BK x TCOLS) payload tile and
//    the block's e_q chunk, filled by 16-byte cp.async.cg (element-wise
//    loads at a ragged or unaligned payload edge; the k_q tail is
//    zero-filled, nothing past the payload is read).  Two stages, not
//    three: an fp32 stage is 32 x 2080 B of payload (TCOLS = 512, rows
//    padded by 8 words) + 8 KB of e_q = 74,752 B, so three stages and one
//    list's queues and anchors (16,768 + 8,320 B) need 249,344 B, above the
//    232,448 B (227 KB) a block may opt into.  The refill of the
//    other stage goes out in four parts between the chunk's k-steps, so
//    its issue overlaps the mma's, and the ring runs on across column
//    tiles, so the next tile's loads overlap this tile's epilogue.  e_q is
//    split into hi/lo once, on the host, in A-fragment order
//    (kernel.py::fragment_split): a warp reads a fragment with one 16-byte
//    load and no block splits it again.  Streaming its 8 KB chunk with
//    each stage (from L2) measured faster than a resident slab split chunk
//    by chunk in the block, and leaves k_q unbounded.  Payload column slots
//    are permuted so that a lane's B values are adjacent (one 16-byte load
//    per four n8 tiles).  The grid is (row groups, column ranges) with row
//    groups fastest, one wave on the card: the blocks that share a column
//    range run together and the payload comes from HBM about once.
// 3. Selection in registers, in batches.  Scale, noise, n_items and the
//    mask are applied to the mma accumulator fragments in registers, in a
//    straight-line pass that drops every value below the row's threshold:
//    the larger of its list's k-th value and the row's published one.
//    Survivors go straight to a per-row queue of QCAP entries in shared
//    memory.  When one overflows, the block merges every queue at least a
//    quarter full and retries.  A merge is warp-parallel, 32 entries a
//    pass: anchor ids score NEG_INF (checked against the row's in-range
//    anchors, gathered once per block), and every queue entry and every
//    list entry learns its rank in the union by counting (the list is
//    sorted, the order (max value, min id) is total) and writes itself to
//    its rank if that is below k.  The block's lists live in its slot of
//    the (B, ranges, k) scratch (L2); a second kernel merges them the same
//    way.  A block whose list holds k real entries publishes its k-th value
//    as the row's global threshold (atomicMax on an order-preserving int
//    image); every block drops values strictly below it, which cannot be in
//    the row's top k.
// 4. Lists longer than KMAX = 256 (the dual-encoder shortlist, k = 800;
//    any k up to KMAX_LARGE = 1024) take a second instantiation of the same
//    sweep (KCH = 4 list chunks): warp_merge reads a list 256 entries at a
//    time, from its last chunk to its first, so its registers are the
//    k <= 256 kernel's and neither instantiation spills.  The lists live
//    in the (B, ranges, k) scratch either way.  persistent_round keeps
//    KMAX = 256.
//
// Ties break by (max value, min id) everywhere.  Masked entries score
// exactly NEG_INF and still compete by id, so an under-filled row returns
// its lowest masked ids, distinct and ascending.  Scale and noise are
// __fmul_rn / __fadd_rn on the finished accumulator: the score is
// (acc * scale) + noise, as in the plain PyTorch version.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace adacur {

constexpr float NEG_INF_F = -1e30f;
constexpr int SENTINEL_ID = 2147483647;
constexpr int ROWS = 32;       // query rows per block (two m16 tiles)
constexpr int THREADS = 256;   // 8 warps; warp w owns columns [WCOLS w, WCOLS (w+1))
constexpr int WARPS = THREADS / 32;
constexpr int NI = 8;          // n8 tiles per warp
constexpr int WCOLS = 8 * NI;  // item columns per warp
constexpr int TCOLS = WARPS * WCOLS;   // item columns per tile
constexpr int NE = 2 * NI * 4;         // accumulators per thread (32 rows x WCOLS / 32 lanes)
constexpr int NCOL = 2 * NI;           // columns per thread
constexpr int BK = 32;         // k_q depth of one ring stage / one chunk
constexpr int QCAP = 64;       // queue entries per row
constexpr int ACAP = 64;       // in-range anchor ids kept per row
constexpr int A_TILE = ROWS * BK;   // floats of one e_q chunk (hi or lo)
constexpr int KMAX = 256;      // largest k of a list held in one chunk (the KCH = 1 kernels)
constexpr int KMAX_LARGE = 1024;   // largest k of approx_topk's large-k instantiation
constexpr int KCH_LARGE = KMAX_LARGE / KMAX;   // its list chunks
constexpr int SMEM_LIMIT = 232448;   // opt-in shared memory per block, sm_90
constexpr unsigned FULL = 0xffffffffu;

// What a payload element is (the wrappers' payload_operands kinds).
enum PayloadKind : int { PK_F32 = 0, PK_I8 = 1, PK_BF16 = 2, PK_FP8 = 3, PK_I4 = 4 };

// Unit: the stored element; COLS: item columns a unit holds; SPLIT: the
// value needs a TF32 lo part; PAD: ring row pad in bytes (see load_b).
template <int K> struct Payload;
template <> struct Payload<PK_F32> {
  using Unit = float;
  static constexpr int COLS = 1, PAD = 32;
  static constexpr bool SPLIT = true;
};
template <> struct Payload<PK_I8> {
  using Unit = uint8_t;
  static constexpr int COLS = 1, PAD = 32;
  static constexpr bool SPLIT = false;
};
template <> struct Payload<PK_BF16> {
  using Unit = uint16_t;
  static constexpr int COLS = 1, PAD = 32;
  static constexpr bool SPLIT = false;
};
template <> struct Payload<PK_FP8> {
  using Unit = uint8_t;
  static constexpr int COLS = 1, PAD = 32;
  static constexpr bool SPLIT = false;
};
template <> struct Payload<PK_I4> {
  using Unit = uint8_t;
  static constexpr int COLS = 2, PAD = 16;
  static constexpr bool SPLIT = false;
};

template <int K>
__host__ __device__ constexpr int stage_ld_bytes() {   // ring row stride
  return TCOLS / Payload<K>::COLS * (int)sizeof(typename Payload<K>::Unit) + Payload<K>::PAD;
}
__host__ __device__ constexpr int list_smem_bytes() {   // queue + count + threshold, per list
  return ROWS * QCAP * 8 + ROWS * 12;
}
__host__ __device__ constexpr int anchor_smem_bytes() {   // in-range anchors
  return ROWS * ACAP * 4 + ROWS * 4;
}
template <int K>
__host__ __device__ constexpr int stage_bytes() {   // payload tile + e_q hi/lo
  return BK * stage_ld_bytes<K>() + 2 * A_TILE * 4;
}
template <int K>
__host__ constexpr size_t sweep_smem_bytes(int nl) {
  return 2 * (size_t)stage_bytes<K>() + (size_t)nl * list_smem_bytes() +
         anchor_smem_bytes();
}

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero: the result of cvt.rna.tf32.f32 for every finite x, computed
// on the integer pipes (the conversion unit has a quarter of their rate).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait for every committed copy: with two stages, the one this step reads.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Merge a queue of candidates into the best-first list lv/li (length k,
// sorted, in global or shared memory).  Lane s holds queue entry
// (qv, qi) if bit s of qmask is set; all 32 lanes call it.  Every entry's
// rank in the union is counted, and it is written there if below k.
//
// The list is read KMAX entries at a time (a chunk: KMAX / 32 a lane, in
// registers), from its last chunk to its first.  An entry only moves down
// the list (to its index plus the queue entries that beat it), so a chunk's
// writes land on entries already read; the queue entries go in last.  KCH
// is the most chunks a list may hold: 1 for k <= KMAX (the serving path's
// lists), KMAX_LARGE / KMAX for the large-k instantiation.
template <int KCH>
__device__ __forceinline__ void warp_merge(float* lv, int* li, int k, float qv,
                                           int qi, unsigned qmask, int lane) {
  constexpr int T = KMAX / 32;
  const bool mine = (qmask >> lane) & 1u;
  int rank = 0;
  // one chunk [base, base + KMAX) of the list; `first` counts the queue
  // entries that beat this lane's entry (once per merge)
  auto chunk = [&](int base, bool first) {
    float rv[T];
    int ri[T], cnt[T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int j = base + lane + 32 * t;
      cnt[t] = 0;
      rv[t] = NEG_INF_F;
      ri[t] = SENTINEL_ID;
      if (j < k) {
        rv[t] = lv[j];
        ri[t] = li[j];
      }
    }
    unsigned m = qmask;
    while (m) {
      const int s = __ffs(m) - 1;
      m &= m - 1;
      const float sv = __shfl_sync(FULL, qv, s);
      const int si = __shfl_sync(FULL, qi, s);
      int list_better = 0;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (base + lane + 32 * t < k) {
          if (better(sv, si, rv[t], ri[t])) ++cnt[t];
          else ++list_better;
        }
      }
      list_better = __reduce_add_sync(FULL, list_better);
      if (lane == s) rank += list_better;
      if (first && mine && better(sv, si, qv, qi)) ++rank;
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int j = base + lane + 32 * t;
      const int pos = j + cnt[t];
      if (j < k && pos < k) {
        lv[pos] = rv[t];
        li[pos] = ri[t];
      }
    }
    __syncwarp();
  };
  if constexpr (KCH == 1) {
    chunk(0, true);
  } else {
    const int top = (k - 1) / KMAX;
#pragma unroll 1
    for (int ch = top; ch >= 0; --ch) chunk(ch * KMAX, ch == top);
  }
  if (mine && rank < k) {
    lv[rank] = qv;
    li[rank] = qi;
  }
  __syncwarp();
}

// The score of accumulator `acc` at element `at` of the (B, N) field:
// dequant scale, optional noise, then the item bound (item_ok: gid <
// n_items) and the optional bool mask.  Anchor ids are checked separately
// (only for entries that would enter a list).
__device__ __forceinline__ float sample_value(float acc, const float* scales,
                                              float scale,
                                              const float* __restrict__ noise,
                                              const uint8_t* __restrict__ mask,
                                              size_t at, bool item_ok) {
  float s = acc;
  if (scales != nullptr) s = __fmul_rn(s, scale);
  if (noise != nullptr) s = __fadd_rn(s, noise[at]);
  const bool keep = item_ok && (mask == nullptr || mask[at] == 0);
  return keep ? s : NEG_INF_F;
}

// An order-preserving int image of a float (for atomicMax) and back.
__device__ __forceinline__ int ordered(float v) {
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7FFFFFFF;
}
__device__ __forceinline__ float unordered(int o) {
  return __int_as_float(o >= 0 ? o : o ^ 0x7FFFFFFF);
}

struct SweepArgs {
  const float* a_hi;     // e_q split to TF32 hi / lo, in A-fragment order:
  const float* a_lo;     // [row group][chunk][BK/8][2][32][4], zero-padded
  int nchunks;           // ceil(KQ / BK)
  const void* payload;   // (KQ, ld) units of a PayloadKind
  const float* scales;   // coded kinds: per-tile scales, else null
  int qtile, B, KQ, N;   // N: logical item columns
  int ld;                // units a payload row holds (ceil(N / 2) packed int4, else N)
  int n_items;
  int range_cols;        // columns per block (multiple of TCOLS)
  int vec_ok;            // payload rows 16-byte aligned
};

struct ListDesc {        // one running top-k list
  const float* noise;    // (B, N) or null
  const uint8_t* mask;   // (B, N) or null
  const int* anchors;    // (B, A) or null
  int A, k;
  float* blk_v;          // (B, ranges, k) per-block lists
  int* blk_i;
  int* gthr;             // (B,) published thresholds, ordered() images
};

struct ListSmem {
  float* qv;   // [ROWS][QCAP]
  int* qi;
  int* qn;     // [ROWS] queue fill
  float* tv;   // [ROWS] threshold = the list's k-th entry
  int* ti;
};

__device__ __forceinline__ ListSmem carve_list(unsigned char*& p) {
  ListSmem s;
  s.qv = reinterpret_cast<float*>(p);
  s.qi = reinterpret_cast<int*>(s.qv + ROWS * QCAP);
  s.qn = s.qi + ROWS * QCAP;
  s.tv = reinterpret_cast<float*>(s.qn + ROWS);
  s.ti = reinterpret_cast<int*>(s.tv + ROWS);
  p += list_smem_bytes();
  return s;
}

// The anchor ids of each row that fall in the block's column range (most
// fall elsewhere), gathered once per block; a row with more than ACAP of
// them is scanned in global memory instead.
struct AnchorSmem {
  int* ids;   // [ROWS][ACAP]
  int* n;     // [ROWS] in-range count
};

__device__ __forceinline__ void gather_anchors(const ListDesc& L, const AnchorSmem& S,
                                               int row0, int B, int cbeg,
                                               int cend, int warp, int lane) {
  for (int rr = warp; rr < ROWS; rr += WARPS) {
    const int row = row0 + rr;
    int cnt = 0;
    for (int base = 0; row < B && base < L.A; base += 32) {
      const int j = base + lane;
      const int id = j < L.A ? L.anchors[(size_t)row * L.A + j] : -1;
      const bool in = id >= cbeg && id < cend;
      const unsigned m = __ballot_sync(FULL, in);
      const int pos = cnt + __popc(m & ((1u << lane) - 1u));
      if (in && pos < ACAP) S.ids[rr * ACAP + pos] = id;
      cnt += __popc(m);
    }
    if (lane == 0) S.n[rr] = cnt;
  }
}

__device__ __forceinline__ bool anchor_hit(const ListDesc& L, const AnchorSmem& S,
                                           int rr, int row, int gid) {
  const int n = S.n[rr];
  if (n > ACAP) {
    const int* anc = L.anchors + (size_t)row * L.A;
    for (int a = 0; a < L.A; ++a)
      if (__ldg(anc + a) == gid) return true;
    return false;
  }
  for (int a = 0; a < n; ++a)
    if (S.ids[rr * ACAP + a] == gid) return true;
  return false;
}

// Fill part `part` (of NPART) of a ring stage: the block's e_q chunk (hi,
// lo; part 0), and rows of one (BK x TCOLS) payload tile, as stored, by
// 16-byte cp.async where it is whole and aligned, unit-wise loads (zeros
// past k_q and the row's ld units; all in part 0) elsewhere.  The parts are
// issued between the mma's of the chunk before, so the copies' issue
// overlaps them.
constexpr int NPART = BK / 8;
template <int K>
__device__ __forceinline__ void load_stage(const SweepArgs& a, int chunk, int c0,
                                           unsigned char* stage, int part) {
  using U = typename Payload<K>::Unit;
  if (part == 0) {   // the block's e_q chunk, split on the host: one 16-byte copy each
    const size_t o = ((size_t)blockIdx.x * a.nchunks + chunk) * A_TILE + threadIdx.x * 4;
    float* dst = reinterpret_cast<float*>(stage + BK * stage_ld_bytes<K>());
    cp_async16(dst + threadIdx.x * 4, a.a_hi + o);
    cp_async16(dst + A_TILE + threadIdx.x * 4, a.a_lo + o);
  }
  const int k0 = chunk * BK;
  constexpr int EPC = 16 / (int)sizeof(U);                // units per 16-byte chunk
  constexpr int CPR = TCOLS / Payload<K>::COLS / EPC;     // 16-byte chunks per row
  constexpr int RPP = THREADS / CPR;    // rows per pass of the block
  constexpr int CPT = BK / RPP;         // copies a thread makes per stage
  constexpr int LDB = stage_ld_bytes<K>();
  const U* pay = static_cast<const U*>(a.payload);
  const int u0 = c0 / Payload<K>::COLS;   // the tile's first unit in a row
  if (a.vec_ok && k0 + BK <= a.KQ && c0 + TCOLS <= a.N) {   // the whole tile
    const int r0 = threadIdx.x / CPR, cc = threadIdx.x % CPR;
    const U* src = pay + (size_t)(k0 + r0) * a.ld + u0 + cc * EPC;
    unsigned char* dst = stage + r0 * LDB + cc * 16;
#pragma unroll
    for (int j = part * CPT / NPART; j < (part + 1) * CPT / NPART; ++j)
      cp_async16(dst + j * RPP * LDB, src + (size_t)j * RPP * a.ld);
    return;
  }
  if (part != 0) return;
  for (int c = threadIdx.x; c < BK * CPR; c += THREADS) {
    const int r = c / CPR, cc = c % CPR;
    const int gq = k0 + r, gu = u0 + cc * EPC;
    unsigned char* dst = stage + r * LDB + cc * 16;
    if (gq < a.KQ && a.vec_ok && gu + EPC <= a.ld) {
      cp_async16(dst, pay + (size_t)gq * a.ld + gu);
    } else {
      U* d = reinterpret_cast<U*>(dst);
#pragma unroll
      for (int e = 0; e < EPC; ++e)
        d[e] = (gq < a.KQ && gu + e < a.ld) ? pay[(size_t)gq * a.ld + gu + e]
                                            : static_cast<U>(0);
    }
  }
}

// The TF32 bit patterns of four adjacent stored columns at p (all exact:
// see the header note).
template <int K>
__device__ __forceinline__ void decode4(const unsigned char* p, uint32_t (&v)[4]) {
  if constexpr (K == PK_I8) {
    // code b -> float: bias to u = b + 128 (flip the sign bit), place u
    // in the mantissa of 2^23 and subtract 2^23 + 128; exact, and on the
    // integer and fp32 pipes rather than the conversion unit
    const uint32_t x = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = __float_as_uint(
          __fsub_rn(__uint_as_float(__byte_perm(x, 0x4B00u, j | 0x5440)), 8388736.f));
  } else if constexpr (K == PK_I4) {
    // nibble n (column 2i low, 2i+1 high) -> u = n + 8 by flipping bit 3,
    // then the int8 path's trick with 2^23 + 8
    const uint32_t x = *reinterpret_cast<const uint16_t*>(p) ^ 0x8888u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = __float_as_uint(
          __fsub_rn(__uint_as_float(0x4B000000u | ((x >> (4 * j)) & 0xFu)), 8388616.f));
  } else if constexpr (K == PK_BF16) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    v[0] = x.x << 16;
    v[1] = x.x & 0xFFFF0000u;
    v[2] = x.y << 16;
    v[3] = x.y & 0xFFFF0000u;
  } else {
    static_assert(K == PK_FP8, "decode4: unknown payload kind");
    // e4m3 byte s eeee mmm: s to bit 31, eeee mmm to bits 20..26, then
    // 2^120 moves the fp32 exponent bias (127) to e4m3's (7)
    const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t y = x << (24 - 8 * j);
      v[j] = __float_as_uint(__fmul_rn(
          __uint_as_float((y & 0x80000000u) | ((y >> 4) & 0x07F00000u)),
          __uint_as_float(0x7B800000u)));
    }
  }
}

// Load one k-step's B fragments from a ring stage: column slot g of
// n-tile ni = 4 grp + j holds the warp's column 32 grp + 4g + j, so a lane
// reads four n-tiles' B values with one load per k row: 16 bytes (fp32), 8
// (bf16), 4 (int8, fp8) or 2 (packed int4).  An fp32 value splits into
// TF32 hi and lo (lo only if LO); every other kind is exact in TF32 and has
// no lo part.
template <int K, bool LO>
__device__ __forceinline__ void load_b(const unsigned char* stage, int ks, int warp, int g,
                                       int t, uint32_t (&bhi)[NI][2], uint32_t (&blo)[NI][2]) {
  using P = Payload<K>;
  constexpr int LDB = stage_ld_bytes<K>();
#pragma unroll
  for (int grp = 0; grp < NI / 4; ++grp) {
    const int col = warp * WCOLS + grp * 32 + 4 * g;
    const unsigned char* r0 =
        stage + (ks * 8 + t) * LDB + col / P::COLS * (int)sizeof(typename P::Unit);
    const unsigned char* r1 = r0 + 4 * LDB;
    if constexpr (K == PK_F32) {
      const float4 x0 = *reinterpret_cast<const float4*>(r0);
      const float4 x1 = *reinterpret_cast<const float4*>(r1);
      const float v0[4] = {x0.x, x0.y, x0.z, x0.w}, v1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (LO) {
          split_tf32(v0[j], bhi[grp * 4 + j][0], blo[grp * 4 + j][0]);
          split_tf32(v1[j], bhi[grp * 4 + j][1], blo[grp * 4 + j][1]);
        } else {
          bhi[grp * 4 + j][0] = tf32_rna(v0[j]);
          bhi[grp * 4 + j][1] = tf32_rna(v1[j]);
        }
      }
    } else {
      uint32_t v0[4], v1[4];
      decode4<K>(r0, v0);
      decode4<K>(r1, v1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bhi[grp * 4 + j][0] = v0[j];
        bhi[grp * 4 + j][1] = v1[j];
      }
    }
  }
}

__device__ __forceinline__ void load_a(const float4* src, int ks, int lane,
                                       uint32_t (&a)[2][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const float4 v = src[(ks * 2 + mi) * 32 + lane];
    a[mi][0] = __float_as_uint(v.x); a[mi][1] = __float_as_uint(v.y);
    a[mi][2] = __float_as_uint(v.z); a[mi][3] = __float_as_uint(v.w);
  }
}

// One BK chunk of the product into the chunk accumulator c, which starts
// at zero: first the small terms of all BK / 8 k-steps (a_lo*b_hi, and
// a_hi*b_lo for an fp32 payload), then the a_hi*b_hi terms.  The tensor
// core truncates each sum it forms to fp32 at the accumulator's scale, so
// the small terms go in while c is still small, and only the a_hi*b_hi
// steps are truncated at the chunk sum's scale.  The B tile is read from
// shared memory once for each half.  (A chain a k-step for the payloads
// exact in TF32, each added to the running sum with __fadd_rn, spilled and
// was less accurate on the card: the four times as many rounded adds cost
// more than the shorter truncating sums saved.)  The accumulator
// c[mi][ni][q] is (row mi*16 + g + 8(q>>1), column 32 grp + 8t + 4(q&1) + j)
// of the warp's 32 x WCOLS tile, for n-tile ni = 4 grp + j.
template <int K, typename Between>
__device__ __forceinline__ void mma_chunk(const float* a_hi, const float* a_lo,
                                          const unsigned char* stage,
                                          float (&c)[2][NI][4], int warp,
                                          int lane, Between between) {
  const int g = lane >> 2, t = lane & 3;
  const float4* ah = reinterpret_cast<const float4*>(a_hi);
  const float4* al = reinterpret_cast<const float4*>(a_lo);
  constexpr bool FP32 = Payload<K>::SPLIT;
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
    uint32_t ahi[2][4], alo[2][4], bhi[NI][2], blo[NI][2];
    load_a(al, ks, lane, alo);
    load_b<K, FP32>(stage, ks, warp, g, t, bhi, blo);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_tf32(c[mi][ni], alo[mi], bhi[ni][0], bhi[ni][1]);
    if constexpr (FP32) {
      load_a(ah, ks, lane, ahi);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_tf32(c[mi][ni], ahi[mi], blo[ni][0], blo[ni][1]);
    }
    between(ks);
  }
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
    uint32_t ahi[2][4], bhi[NI][2], unused[NI][2];
    load_a(ah, ks, lane, ahi);
    load_b<K, false>(stage, ks, warp, g, t, bhi, unused);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_tf32(c[mi][ni], ahi[mi], bhi[ni][0], bhi[ni][1]);
  }
}

// Merge queue row rr (n entries) into the block's list of that row; one
// warp.  Queued entries passed only the value threshold: here an anchor id
// scores NEG_INF (and still competes by id), and the merge's exact ranks
// drop what does not make the list.  Resets the queue, refreshes the
// cached threshold and publishes a full list's k-th value as the row's
// global threshold.
template <int KCH>
__device__ __forceinline__ void flush_row(const ListDesc& L, const ListSmem& S,
                                          const AnchorSmem& AS, int rr, int row,
                                          int n, float* lv, int* li, int lane) {
  for (int base = 0; base < n; base += 32) {
    const int m = min(32, n - base);
    const bool in = lane < m;
    float qv = in ? S.qv[rr * QCAP + base + lane] : NEG_INF_F;
    const int qi = in ? S.qi[rr * QCAP + base + lane] : SENTINEL_ID;
    if (in && L.A > 0 && anchor_hit(L, AS, rr, row, qi)) qv = NEG_INF_F;
    warp_merge<KCH>(lv, li, L.k, qv, qi, m >= 32 ? FULL : ((1u << m) - 1u), lane);
  }
  if (lane == 0) {
    const float kth = lv[L.k - 1];
    S.qn[rr] = 0;
    S.tv[rr] = kth;
    S.ti[rr] = li[L.k - 1];
    if (kth > NEG_INF_F) atomicMax(L.gthr + row, ordered(kth));
  }
}

// What a thread's NCOL columns of the current tile share across its four
// rows.  Column cc is 32 (cc >> 3) + 8t + (cc & 7) of the warp's WCOLS.
struct TileCols {
  int gid0;           // id of the warp's column 8t
  unsigned inr;       // bit cc: inside the block's range
  unsigned item;      // bit cc: below n_items
  float scale[NCOL];  // tile scale of column cc (coded kinds)
};

__device__ __forceinline__ int col_of(int cc) { return 32 * (cc >> 3) + (cc & 7); }

__device__ __forceinline__ TileCols tile_cols(const SweepArgs& a, int col0, int cend,
                                              int warp, int lane) {
  TileCols tc;
  tc.gid0 = col0 + warp * WCOLS + 8 * (lane & 3);
  tc.inr = tc.item = 0;
#pragma unroll
  for (int cc = 0; cc < NCOL; ++cc) {
    const int gid = tc.gid0 + col_of(cc);
    tc.inr |= (gid < cend ? 1u : 0u) << cc;
    tc.item |= (gid < a.n_items ? 1u : 0u) << cc;
    tc.scale[cc] = (a.scales != nullptr && gid < cend) ? __ldg(a.scales + gid / a.qtile) : 1.f;
  }
  return tc;
}

// x[e] for a runtime index, by selects (no local memory).
template <int N, typename T>
__device__ __forceinline__ T pick(const T* x, int e) {
  T v = x[0];
#pragma unroll
  for (int i = 1; i < N; ++i) v = i == e ? x[i] : v;
  return v;
}

// Offer the tile's 32 x TCOLS accumulators to one list.  Each thread holds
// NE of them: element e = (mi*NI + ni)*4 + q is row mi*16 + g + 8(q>>1),
// column cc = 8 (ni >> 2) + 4(q&1) + (ni & 3) of its TileCols.  A
// straight-line pass drops every value below max(published threshold gf,
// the list's k-th value) and queues the rest; a full queue leaves its
// candidates pending, and the block then merges every queue at least a
// quarter full between barriers and retries them until every one is in.
template <int KCH>
__device__ __forceinline__ void offer_tile(const SweepArgs& a, const ListDesc& L,
                                           const ListSmem& S, const AnchorSmem& AS,
                                           const float (&acc)[2][NI][4], int col0,
                                           int cend, const float (&gf)[4], int row0,
                                           int rblk, int nranges, int warp, int lane) {
  const int g = lane >> 2;
  const TileCols tc = tile_cols(a, col0, cend, warp, lane);
  float lo[4];
  unsigned rows_ok = 0;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int rr = (h >> 1) * 16 + g + 8 * (h & 1);
    lo[h] = fmaxf(gf[h], S.tv[rr]);
    rows_ok |= (row0 + rr < a.B ? 1u : 0u) << h;
  }
  // value of element e, and whether it passes the thresholds lo
  auto value = [&](int e, float x, bool& pass) -> float {
    const int ni = (e >> 2) % NI, q = e & 3;
    const int h = (e / (4 * NI)) * 2 + (q >> 1), cc = 8 * (ni >> 2) + 4 * (q & 1) + (ni & 3);
    const bool valid = (tc.inr >> cc) & (rows_ok >> h) & 1u;
    const size_t at = valid ? (size_t)(row0 + (e / (4 * NI)) * 16 + g + 8 * (q >> 1)) * a.N +
                                  tc.gid0 + col_of(cc)
                            : 0;
    // pick: e is a constant in the unrolled pass, and registers stay
    // registers where the retry passes it at run time
    const float v = sample_value(x, a.scales, pick<NCOL>(tc.scale, cc), L.noise, L.mask, at,
                                 (tc.item >> cc) & 1u);
    pass = valid && v >= pick<4>(lo, h);
    return v;
  };
  // queue element e's value v; false = the row's queue is full
  auto push = [&](int e, float v) -> bool {
    const int ni = (e >> 2) % NI, q = e & 3;
    const int rr = (e / (4 * NI)) * 16 + g + 8 * (q >> 1);
    const int pos = atomicAdd(S.qn + rr, 1);
    if (pos >= QCAP) return false;
    S.qv[rr * QCAP + pos] = v;
    S.qi[rr * QCAP + pos] = tc.gid0 + col_of(8 * (ni >> 2) + 4 * (q & 1) + (ni & 3));
    return true;
  };
  unsigned long long pend = 0;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    bool pass;
    const float v = value(e, acc[e / (4 * NI)][(e >> 2) % NI][e & 3], pass);
    if (pass && !push(e, v)) pend |= 1ull << e;
  }
  while (__syncthreads_or(pend != 0)) {
    for (int rr = warp; rr < ROWS; rr += WARPS) {
      const int row = row0 + rr;
      const int n = S.qn[rr];
      if (row < a.B && n >= QCAP / 4) {
        const size_t o = ((size_t)row * nranges + rblk) * L.k;
        flush_row<KCH>(L, S, AS, rr, row, min(n, QCAP), L.blk_v + o, L.blk_i + o, lane);
      }
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 4; ++h) lo[h] = fmaxf(gf[h], S.tv[(h >> 1) * 16 + g + 8 * (h & 1)]);
    unsigned long long m = pend;
    pend = 0;
    while (m) {
      const int e = __ffsll(m) - 1;
      m &= m - 1;
      bool pass;
      const float v = value(e, pick<NE>(&acc[0][0][0], e), pass);
      if (pass && !push(e, v)) pend |= 1ull << e;
    }
  }
}

// The rows' published thresholds, as floats (stale values are safe: they
// only rise).
__device__ __forceinline__ void load_gthr(const ListDesc& L, int row0, int B,
                                          int lane, float (&gf)[4]) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int row = row0 + (h >> 1) * 16 + (lane >> 2) + 8 * (h & 1);
    gf[h] = row < B ? unordered(__ldcg(L.gthr + row)) : 0.f;
  }
}

// The fused sweep: block (row group x, column range y) scores its 32 rows
// against its columns tile by tile and keeps NL running lists per row.
template <int K, int NL, int KCH>
__global__ void __launch_bounds__(THREADS, 1)
sweep_kernel(SweepArgs a, ListDesc l0, ListDesc l1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;
  constexpr int STAGE_BYTES = stage_bytes<K>();
  constexpr int A_OFF = BK * stage_ld_bytes<K>();   // e_q hi/lo within a stage
  unsigned char* p = ring + 2 * STAGE_BYTES;
  ListSmem s0 = carve_list(p);
  ListSmem s1 = s0;
  if (NL == 2) s1 = carve_list(p);
  const AnchorSmem as{reinterpret_cast<int*>(p), reinterpret_cast<int*>(p) + ROWS * ACAP};

  const int row0 = blockIdx.x * ROWS;
  const int rblk = blockIdx.y;
  const int nranges = gridDim.y;
  const int cbeg = rblk * a.range_cols;
  const int cend = min(a.N, cbeg + a.range_cols);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const ListDesc& L = l == 0 ? l0 : l1;
    const ListSmem& S = l == 0 ? s0 : s1;
    for (int i = threadIdx.x; i < ROWS * L.k; i += THREADS) {
      const int row = row0 + i / L.k;
      if (row < a.B) {
        const size_t o = ((size_t)row * nranges + rblk) * L.k + i % L.k;
        L.blk_v[o] = NEG_INF_F;
        L.blk_i[o] = SENTINEL_ID;
      }
    }
    for (int i = threadIdx.x; i < ROWS; i += THREADS) {
      S.qn[i] = 0;
      S.tv[i] = NEG_INF_F;
      S.ti[i] = SENTINEL_ID;
    }
  }
  gather_anchors(l0, as, row0, a.B, cbeg, cend, warp, lane);   // list 0 only has anchors
  __syncthreads();

  const int nchunks = a.nchunks;
  const int ntiles = (cend - cbeg + TCOLS - 1) / TCOLS;
  const int nsteps = ntiles * nchunks;
  for (int part = 0; part < NPART; ++part) load_stage<K>(a, 0, cbeg, ring, part);
  cp_async_commit();

  float acc[2][NI][4], c[2][NI][4];
  for (int tile = 0; tile < ntiles; ++tile) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] = c[mi][ni][q] = 0.f;
    for (int chunk = 0; chunk < nchunks; ++chunk) {
      const int s = tile * nchunks + chunk;
      cp_async_wait_all();
      __syncthreads();
      // every warp has passed this barrier, so the other stage is free: its
      // refill goes out in NPART parts, one before and the rest between this
      // chunk's k-steps
      const int nx = s + 1;
      const int nx_chunk = nx % nchunks, nx_col = cbeg + (nx / nchunks) * TCOLS;
      unsigned char* nx_stage = ring + (nx & 1) * STAGE_BYTES;
      auto refill = [&](int part) {
        if (nx < nsteps && part < NPART) load_stage<K>(a, nx_chunk, nx_col, nx_stage, part);
      };
      refill(0);
      const unsigned char* st = ring + (s & 1) * STAGE_BYTES;
      const float* ab = reinterpret_cast<const float*>(st + A_OFF);
      mma_chunk<K>(ab, ab + A_TILE, st, c, warp, lane, [&](int ks) { refill(ks + 1); });
      cp_async_commit();
      if (chunk + 1 < nchunks) {
        // add the chunk to the running sum and start the next chunk's
        // accumulator at that add's rounding error (Fast2Sum: exact while
        // |acc| >= |c|; design note 1)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float sum = __fadd_rn(acc[mi][ni][q], c[mi][ni][q]);
              c[mi][ni][q] = __fsub_rn(c[mi][ni][q], __fsub_rn(sum, acc[mi][ni][q]));
              acc[mi][ni][q] = sum;
            }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] = __fadd_rn(acc[mi][ni][q], c[mi][ni][q]);
    // loaded here, not during the mma's: that spilled (two lists)
    const int col0 = cbeg + tile * TCOLS;
    float gf0[4], gf1[4];
    load_gthr(l0, row0, a.B, lane, gf0);
    if (NL == 2) load_gthr(l1, row0, a.B, lane, gf1);
    offer_tile<KCH>(a, l0, s0, as, acc, col0, cend, gf0, row0, rblk, nranges, warp, lane);
    if (NL == 2)
      offer_tile<KCH>(a, l1, s1, as, acc, col0, cend, gf1, row0, rblk, nranges, warp, lane);
  }
  asm volatile("cp.async.wait_all;\n" ::);

  // merge what the queues still hold
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const ListDesc& L = l == 0 ? l0 : l1;
    const ListSmem& S = l == 0 ? s0 : s1;
    for (int rr = warp; rr < ROWS; rr += WARPS) {
      const int row = row0 + rr;
      const int n = S.qn[rr];
      if (row < a.B && n > 0) {
        const size_t o = ((size_t)row * nranges + rblk) * L.k;
        flush_row<KCH>(L, S, as, rr, row, n, L.blk_v + o, L.blk_i + o, lane);
      }
    }
  }
}

// Merge per-block lists (B, M) -> (B, k) by the same rule; one warp per
// row, 32 candidates at a time, those that beat the list's last entry
// merged by warp_merge.
template <int KCH>
__global__ void merge_topk_kernel(const float* __restrict__ v,
                                  const int* __restrict__ ids, int M, int k,
                                  float* __restrict__ out_v,
                                  int* __restrict__ out_i) {
  const int lane = threadIdx.x;
  const size_t row = blockIdx.x;
  float* lv = out_v + row * k;
  int* li = out_i + row * k;
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
    const unsigned m = __ballot_sync(FULL, pass);
    if (m) warp_merge<KCH>(lv, li, k, cv, cg, m, lane);
  }
}

// Launch the sweep and one merge per list.  Returns a cudaError_t.
template <int K, int NL, int KCH>
int launch_sweep(SweepArgs a, const ListDesc& l0, const ListDesc& l1,
                 float* const out_v[2], int* const out_i[2],
                 cudaStream_t stream) {
  // A row's length in units, and whether every payload row starts 16-byte
  // aligned: the base is, and a row holds whole 16-byte chunks.
  using P = Payload<K>;
  constexpr int cols16 = 16 / (int)sizeof(typename P::Unit) * P::COLS;
  a.ld = (a.N + P::COLS - 1) / P::COLS;
  a.vec_ok = reinterpret_cast<uintptr_t>(a.payload) % 16 == 0 && a.N % cols16 == 0;
  const size_t smem = sweep_smem_bytes<K>(NL);
  if (smem > (size_t)SMEM_LIMIT || a.range_cols % TCOLS != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<K, NL, KCH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int l = 0; l < NL; ++l) {   // 0x80808080: below every ordered() value used
    err = cudaMemsetAsync((l == 0 ? l0 : l1).gthr, 0x80, sizeof(int) * a.B, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const int nranges = (a.N + a.range_cols - 1) / a.range_cols;
  dim3 grid((a.B + ROWS - 1) / ROWS, nranges);
  sweep_kernel<K, NL, KCH><<<grid, THREADS, smem, stream>>>(a, l0, l1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int l = 0; l < NL; ++l) {
    const ListDesc& L = l == 0 ? l0 : l1;
    merge_topk_kernel<KCH><<<a.B, 32, 0, stream>>>(L.blk_v, L.blk_i, nranges * L.k, L.k,
                                              out_v[l], out_i[l]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// The sweep's arguments; launch_sweep<K> fills in the payload's layout.
inline SweepArgs sweep_args(const float* a_hi, const float* a_lo, const void* payload,
                            const float* scales, int qtile, int B, int KQ, int N,
                            int n_items, int range_cols) {
  return SweepArgs{a_hi, a_lo, (KQ + BK - 1) / BK, payload, scales, qtile, B, KQ, N,
                   0, n_items, range_cols, 0};
}

// The payload kinds a build instantiates, a bitmask of 1 << PayloadKind
// (all five unless the build defines it): kernels/build.py compiles each
// top-k source more than once, each build a few kinds (VARIANTS there),
// so the sweep's instantiations spread over more nvcc processes.  A call
// on a kind the build left out is refused.
#ifndef ADACUR_KINDS
#define ADACUR_KINDS 0x1f
#endif

template <int PK, int NL, int KCH>
int launch_if_built(const SweepArgs& a, const ListDesc& l0, const ListDesc& l1,
                    float* const out_v[2], int* const out_i[2], cudaStream_t stream) {
  if constexpr (((ADACUR_KINDS) >> PK) & 1)
    return launch_sweep<PK, NL, KCH>(a, l0, l1, out_v, out_i, stream);
  else
    return (int)cudaErrorInvalidValue;
}

// launch_sweep for a payload kind known at run time; KCH list chunks
// (KCH_LARGE for approx_topk's large-k lists).
template <int NL, int KCH = 1>
int launch_kind(int kind, const SweepArgs& a, const ListDesc& l0, const ListDesc& l1,
                float* const out_v[2], int* const out_i[2], cudaStream_t stream) {
  switch (kind) {
    case PK_F32: return launch_if_built<PK_F32, NL, KCH>(a, l0, l1, out_v, out_i, stream);
    case PK_I8: return launch_if_built<PK_I8, NL, KCH>(a, l0, l1, out_v, out_i, stream);
    case PK_BF16: return launch_if_built<PK_BF16, NL, KCH>(a, l0, l1, out_v, out_i, stream);
    case PK_FP8: return launch_if_built<PK_FP8, NL, KCH>(a, l0, l1, out_v, out_i, stream);
    case PK_I4: return launch_if_built<PK_I4, NL, KCH>(a, l0, l1, out_v, out_i, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace adacur
