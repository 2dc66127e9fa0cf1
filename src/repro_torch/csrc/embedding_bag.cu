// Fixed-width multi-hot embedding bag for Hopper (sm_90a).
//
// Replaces the TPU kernel _bag_kernel
// (src/repro/kernels/embedding_bag/kernel.py:26, launched by embedding_bag
// at :45): out[b] = sum_h table[ids[b, h]], or that sum / H for "mean",
// accumulated in fp32 whatever the table dtype, h = 0..H-1 in ascending
// order, then cast once to the table's dtype.  Ids follow jnp.take, the
// reference oracle's gather: an id in [-rows, 0) wraps once, and an id
// outside [-rows, rows) reads as a row of NaN (no memory outside the table
// is touched).
//
// Bound on an H100.  A bag moves H rows in and one row out, and adds
// H * dim numbers: about one add per four bytes, so the bytes bound it
// everywhere (DLRM's per-field lookup at B = 262,144, dim 128, fp32: 269 MB,
// 80 us at 3.35 TB/s).  The rows are scattered over a table much larger
// than the 50 MB L2, so every row is a fresh read from device memory.
//
// The backward (bag_bwd below, added for training; the TPU kernel has no
// backward: the reference differentiates its jnp.take oracle, an XLA
// scatter-add) writes d table, a dense (rows, dim) fp32 array.
//
// What the forward's design does about its bound (simple first): one warp
// per bag, eight
// bags per block.  A lane owns 16 bytes of each row chunk (4 fp32 or 8
// bf16 values) and reads them with one 16-byte load when the row length
// allows it, so a warp reads 512 contiguous bytes of a row at once; the
// fp32 accumulators stay in registers across the H rows.  The lanes load
// 32 ids at a time and broadcast each with __shfl_sync.  Row offsets are
// 64-bit (2^24 rows x 128 = 2^31 elements).  No shared memory, no TMA, no
// table-batched launch yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace bag {

constexpr int WARPS = 8;                  // bags per block
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC values per lane per chunk; VEC16 says one 16-byte load moves them.
template <typename T, int VEC, bool VEC16>
__global__ void __launch_bounds__(THREADS)
bag_kernel(const T* __restrict__ table, const int* __restrict__ ids,
           T* __restrict__ out, long long B, int H, long long rows, int dim,
           int mean) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;
  const int* bag_ids = ids + b * H;
  const float nan_f = __int_as_float(0x7fc00000);
  for (int c0 = 0; c0 < dim; c0 += 32 * VEC) {
    const int c = c0 + lane * VEC;
    const bool mine = c < dim;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
    for (int h0 = 0; h0 < H; h0 += 32) {
      long long my_id = (h0 + lane < H) ? (long long)bag_ids[h0 + lane] : 0;
      const int hn = min(32, H - h0);
#pragma unroll 4
      for (int i = 0; i < hn; ++i) {
        long long id = __shfl_sync(0xffffffffu, my_id, i);
        if (id < 0) id += rows;
        if (!mine) continue;
        if (id < 0 || id >= rows) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] += nan_f;
          continue;
        }
        const T* row = table + id * (long long)dim + c;
        if (VEC16) {
          const uint4 raw = *reinterpret_cast<const uint4*>(row);
          const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] += to_f(v[j]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            if (c + j < dim) acc[j] += to_f(row[j]);
        }
      }
    }
    if (!mine) continue;
    if (mean) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = acc[j] / (float)H;
    }
    T* o = out + b * (long long)dim + c;
    if (VEC16) {
      uint4 raw;
      T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = from_f<T>(acc[j]);
      *reinterpret_cast<uint4*>(o) = raw;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        if (c + j < dim) o[j] = from_f<T>(acc[j]);
    }
  }
}

template <typename T>
static int launch(const void* table, const void* ids, void* out, long long B,
                  int H, long long rows, int dim, int mean, int vec16,
                  cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const unsigned grid = (unsigned)((B + WARPS - 1) / WARPS);
  const T* t = static_cast<const T*>(table);
  const int* i = static_cast<const int*>(ids);
  T* o = static_cast<T*>(out);
  if (vec16)
    bag_kernel<T, VEC, true><<<grid, THREADS, 0, stream>>>(t, i, o, B, H, rows, dim, mean);
  else
    bag_kernel<T, VEC, false><<<grid, THREADS, 0, stream>>>(t, i, o, B, H, rows, dim, mean);
  return (int)cudaGetLastError();
}

}  // namespace bag

// dtype: 0 = float32, 1 = bfloat16 (table and out alike).  table is a
// contiguous (rows, dim) array, ids a contiguous (B, H) int32 array (the
// reference kernel's id type), out a contiguous (B, dim) array.  vec16 = 1
// promises dim * sizeof(T) % 16 == 0 and 16-byte aligned table and out.
extern "C" int embedding_bag_launch(const void* table, const void* ids, void* out,
                                    int dtype, long long B, int H,
                                    long long rows, int dim, int mean, int vec16,
                                    void* stream) {
  if (B < 1 || H < 1 || rows < 1 || dim < 1 || dtype < 0 || dtype > 1 ||
      (B + bag::WARPS - 1) / bag::WARPS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return bag::launch<__nv_bfloat16>(table, ids, out, B, H, rows, dim, mean, vec16, s);
  return bag::launch<float>(table, ids, out, B, H, rows, dim, mean, vec16, s);
}


// ---------------------------------------------------------------------------
// Backward: d table[r] = sum over the lookups j = (b, h) with ids[b, h] = r
// of grad_out[b] (or grad_out[b] / H for "mean", an fp32 divide), a dense
// (rows, dim) fp32 array; an id outside [-rows, rows) gives nothing
// (jnp.take's scatter-add drops it).  It replaces no TPU kernel: it is the
// gradient of _bag_kernel (src/repro/kernels/embedding_bag/kernel.py:26),
// which the reference takes as jnp.take's scatter-add.
//
// Bound on an H100: bytes.  The contract is the dense gradient (AdamW reads
// it densely), so every row is written, zeros included, and grad_out and
// the ids are read once: one DLRM field at B = 65,536, dim 128, over a
// 2^22-row table moves 2.15 GB + 33.5 MB + 0.26 MB, 0.651 ms at 3.35 TB/s;
// over a small table the grad_out read sets it (~10 us).  What the design
// does about it:
//  1. Every row is written once, by the kernels, 512 contiguous bytes a
//     warp-wide 16-byte evict-first store (dim 128, fp32): the wrapper
//     allocates d table with torch.empty, and no fill pass runs before.
//  2. A stable LSD radix sort of the lookups by row, on int32 keys the
//     kernels compute from the int32 ids (wrap once; a dropped id becomes
//     the key `rows`, so it sorts last), over only the bits the table needs
//     (ceil(log2(rows + 1)), at most DIGIT_BITS a pass: one pass up to
//     1,023 rows, three at 2^22).  A pass is digit_counts (a block's digit
//     histogram in shared memory), scan_counts (one block scans the
//     digit-major counts) and scatter_digits (a warp ranks its 128 keys
//     with __match_any_sync against its own counts in shared memory; the
//     warps' counts are offset in warp order).  The rank is (block, warp,
//     round, lane) = lookup order, so the sort is stable by construction
//     and its order depends on the ids alone.  Pass 0 also builds a bitmap
//     of the rows hit.  A few MB of traffic at DLRM's shapes.
//  3. sum_rows: a warp a window of CHUNK = 32 sorted positions, one a lane;
//     it loads its lanes' keys, bags and the two neighbouring keys at once
//     (no search), then sums each row's piece of the window in lookup order
//     from +0.0 with DEPTH grad_out rows in flight.  A row whose lookups all
//     lie in the window is stored straight into d table; a piece of a row
//     that runs past the window goes to a slot (2t for the row at the
//     window's first position, 2t + 1 for its last row), and the window
//     where such a row starts records {start, row}.  Its other blocks (a
//     warp a bitmap word) store the zero rows.
//  4. combine_heavy, a block a window: the row that starts there and runs
//     on (m pieces, one a window it spans; its end found by a block-wide
//     search) is summed in GROUPS groups of q = ceil(m / GROUPS) consecutive
//     pieces, a warp a group in piece order from +0.0, and warp 0 adds the
//     groups' sums in group order from +0.0 and stores the row.  No warp
//     walks more than q pieces (Criteo's 3-row table at B = 65,536: 683
//     pieces a row, 86 a warp).
//  5. A d table of SPLIT_BYTES or more: its zero rows (bandwidth) run on the
//     caller's stream from when pass 0's counts have built the bitmap, and
//     the rest of the sort, sum_rows's windows and combine_heavy (latency)
//     beside them on a high-priority stream, which the caller's stream then
//     waits for.  The sort's latency hides under the 2 GB of zeros.
// No floating-point atomics (the integer counts and the bitmap's ORs give
// the same totals in any order): every row is written once, by one warp,
// in an order fixed by (ids, CHUNK, GROUPS) alone, so two calls give the
// same bits.  ref.py's embedding_bag_backward_emulated repeats the order.
// ---------------------------------------------------------------------------

namespace bag_bwd {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ITEMS = 4;                    // keys a thread ranks in a radix pass
constexpr int SORT_TILE = THREADS * ITEMS;  // keys a block ranks in a radix pass
constexpr int DIGIT_BITS = 10;              // at most, a pass
constexpr int MAX_RADIX = 1 << DIGIT_BITS;
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 32;              // counts a thread of the scan holds
// the tile, a pad word after every 32 counts (no bank conflicts): 132 KB
constexpr int SCAN_SMEM = SCAN_THREADS * (SCAN_ITEMS + 1) * 4;
constexpr int CHUNK = 32;                   // sorted positions a window (a warp) sums
constexpr int DEPTH = 8;                    // grad_out rows a warp has in flight
constexpr int ZERO_ROWS = 32;               // rows a warp of the zero blocks owns: a word
constexpr int GROUPS = WARPS;               // warps that combine a long row's pieces
constexpr int HIT_SMEM_ROWS = 8192;         // a table up to this: hit flags in shared memory
constexpr long long SPLIT_BYTES = 1LL << 26;   // zero rows of a d table this large: own stream
static_assert(CHUNK == 32, "a window is one position a lane");
static_assert(ZERO_ROWS == 32, "a zero warp owns one word of the bitmap");
constexpr unsigned FULL = 0xffffffffu;

struct Ids {
  const int* p;
  long long sb, sh;                         // element strides of (B, H)
  int H, rows;
};

// the lookup j = b * H + h's row key: its id wrapped once, `rows` if dropped
__device__ __forceinline__ int key_of(const Ids& ids, long long j) {
  const long long b = j / ids.H;
  const long long h = j - b * ids.H;
  long long id = ids.p[b * ids.sb + h * ids.sh];
  if (id < 0) id += ids.rows;
  return (id < 0 || id >= ids.rows) ? ids.rows : (int)id;
}

// the bitmap of rows hit, cleared for pass 0's counts to set
__global__ void __launch_bounds__(THREADS)
clear_hit(unsigned* __restrict__ hit, long long words) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < words;
       i += (long long)gridDim.x * THREADS)
    hit[i] = 0u;
}

// Sets row k's bit in the bitmap of rows hit: through byte flags in shared
// memory (plain stores) for a table of at most HIT_SMEM_ROWS rows, else one
// atomicOr (integer ORs, whose result does not depend on their order).
__device__ __forceinline__ void mark_hit(unsigned* hit, unsigned* flags, bool small, int k) {
  if (small) reinterpret_cast<unsigned char*>(flags)[k] = 1;
  else atomicOr(&hit[k >> 5], 1u << (k & 31));
}

// ORs a block's byte flags into the bitmap of rows hit
__device__ __forceinline__ void flush_hit(unsigned* hit, const unsigned* flags, int rows) {
  for (int i = threadIdx.x; i < (rows + 31) / 32; i += blockDim.x) {
    unsigned word = 0u;
    for (int j = 0; j < 32 && i * 32 + j < rows; ++j)
      word |= (unsigned)reinterpret_cast<const unsigned char*>(flags)[i * 32 + j] << j;
    if (word) atomicOr(&hit[i], word);
  }
}

// A pass's digit counts, a block's in shared memory (integer atomics).
// Pass 0 (FROM_IDS) computes the keys from the ids and, by `hit_mode`,
// clears the bitmap of rows hit (0; its scatter sets it) or sets it (1;
// clear_hit cleared it).
template <bool FROM_IDS>
__global__ void __launch_bounds__(THREADS)
digit_counts(Ids ids, const int* __restrict__ keys, int* __restrict__ counts,
             unsigned* __restrict__ hit, long long n, long long nb, int shift, int mask,
             int radix, int hit_mode) {
  __shared__ int cnt[MAX_RADIX];
  __shared__ unsigned flags[FROM_IDS ? HIT_SMEM_ROWS / 4 : 1];   // a byte a row
  const bool mark = FROM_IDS && hit_mode == 1, small = mark && ids.rows <= HIT_SMEM_ROWS;
  if (FROM_IDS && hit_mode == 0) {
    const long long words = ((long long)ids.rows + 31) / 32;
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < words;
         i += (long long)gridDim.x * THREADS)
      hit[i] = 0u;
  }
  for (int d = threadIdx.x; d < radix; d += THREADS) cnt[d] = 0;
  if (small)
    for (int i = threadIdx.x; i < (ids.rows + 3) / 4; i += THREADS) flags[i] = 0u;
  __syncthreads();
  const long long base = (long long)blockIdx.x * SORT_TILE + threadIdx.x;
  int k[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long j = base + i * THREADS;
    k[i] = j >= n ? -1 : FROM_IDS ? key_of(ids, j) : keys[j];
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (k[i] < 0) continue;
    atomicAdd(&cnt[(k[i] >> shift) & mask], 1);
    if (mark && k[i] < ids.rows) mark_hit(hit, flags, small, k[i]);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += THREADS)
    counts[(long long)d * nb + blockIdx.x] = cnt[d];
  if (small) flush_hit(hit, flags, ids.rows);
}

// exclusive scan, in place, of len counts (digit-major: each digit's blocks
// in block order), in one block, SCAN_THREADS * SCAN_ITEMS counts a step:
// read and written coalesced through shared memory, a thread's SCAN_ITEMS
// consecutive counts scanned in place there
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__global__ void __launch_bounds__(SCAN_THREADS)
scan_counts(int* __restrict__ counts, long long len) {
  constexpr int TILE = SCAN_THREADS * SCAN_ITEMS;
  extern __shared__ int tile[];             // TILE counts, padded
  __shared__ int warp_sum[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int carry = 0;
  for (long long t0 = 0; t0 < len; t0 += TILE) {
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) {
      const long long at = t0 + i * SCAN_THREADS + threadIdx.x;
      tile[padded(i * SCAN_THREADS + threadIdx.x)] = at < len ? counts[at] : 0;
    }
    __syncthreads();
    int own = 0;
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) own += tile[padded(threadIdx.x * SCAN_ITEMS + i)];
    int incl = own;                         // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sum[w] = incl;
    __syncthreads();
    if (w == 0) {
      int y = warp_sum[lane];               // SCAN_THREADS / 32 == 32 warps
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int z = __shfl_up_sync(FULL, y, o);
        if (lane >= o) y += z;
      }
      warp_sum[lane] = y;
    }
    __syncthreads();
    int run = carry + incl - own + (w > 0 ? warp_sum[w - 1] : 0);
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) {
      int* at = tile + padded(threadIdx.x * SCAN_ITEMS + i);
      const int x = *at;
      *at = run;
      run += x;
    }
    carry += warp_sum[31];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) {
      const long long at = t0 + i * SCAN_THREADS + threadIdx.x;
      if (at < len) counts[at] = tile[padded(i * SCAN_THREADS + threadIdx.x)];
    }
    __syncthreads();                        // tile and warp_sum are reused
  }
}

// One pass's stable scatter by the digit (key >> shift) & mask, of which
// there are radix.  Pass 0 (FROM_IDS) with mark set sets the
// bitmap of rows hit that its counts cleared.
template <bool FROM_IDS>
__global__ void __launch_bounds__(THREADS)
scatter_digits(Ids ids, const int* __restrict__ keys_in, const int* __restrict__ pos_in,
               const int* __restrict__ offsets, int* __restrict__ keys_out,
               int* __restrict__ pos_out, unsigned* __restrict__ hit, long long n,
               long long nb, int shift, int mask, int radix, int mark) {
  __shared__ int wcnt[WARPS][MAX_RADIX];
  __shared__ unsigned flags[FROM_IDS ? HIT_SMEM_ROWS / 4 : 1];   // a byte a row
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const bool small = FROM_IDS && mark && ids.rows <= HIT_SMEM_ROWS;
  for (int i = threadIdx.x; i < WARPS * radix; i += THREADS) wcnt[i / radix][i % radix] = 0;
  if (small)
    for (int i = threadIdx.x; i < (ids.rows + 3) / 4; i += THREADS) flags[i] = 0u;
  __syncthreads();
  const unsigned lt = (1u << lane) - 1u;
  // warp w ranks the block's keys [w * 32 * ITEMS, (w + 1) * 32 * ITEMS)
  const long long base = (long long)blockIdx.x * SORT_TILE + (long long)w * 32 * ITEMS;
  int key[ITEMS], pos[ITEMS], rank[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long j = base + i * 32 + lane;
    key[i] = 0;
    pos[i] = 0;
    if (j < n) {
      key[i] = FROM_IDS ? key_of(ids, j) : keys_in[j];
      pos[i] = FROM_IDS ? (int)j : pos_in[j];
    }
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const bool valid = base + i * 32 + lane < n;
    const int d = (key[i] >> shift) & mask;
    if (FROM_IDS && mark && valid && key[i] < ids.rows) mark_hit(hit, flags, small, key[i]);
    const unsigned active = __ballot_sync(FULL, valid);
    unsigned peers = 0;
    int before = 0;
    if (valid) {
      peers = __match_any_sync(active, d);
      before = wcnt[w][d];
    }
    __syncwarp();
    if (valid && (peers & lt) == 0) wcnt[w][d] = before + __popc(peers);
    __syncwarp();
    rank[i] = before + __popc(peers & lt);
  }
  __syncthreads();
  if (small) flush_hit(hit, flags, ids.rows);
  // each digit's start for each warp: the block's offset, then the earlier
  // warps' counts
  for (int d = threadIdx.x; d < radix; d += THREADS) {
    int run = offsets[(long long)d * nb + blockIdx.x];
    for (int v = 0; v < WARPS; ++v) {
      const int c = wcnt[v][d];
      wcnt[v][d] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (base + i * 32 + lane >= n) continue;
    const int at = wcnt[w][(key[i] >> shift) & mask] + rank[i];
    keys_out[at] = key[i];
    pos_out[at] = pos[i];
  }
}

// The first i in [lo, hi) with K[i] >= key (hi if none), K sorted.  The
// whole block calls it with the same arguments: THREADS probes a step cut
// the range (THREADS + 1)-fold.
__device__ long long block_lower_bound(const int* __restrict__ K, long long lo, long long hi,
                                       long long key) {
  constexpr long long T = THREADS;
  while (hi - lo > T) {
    const long long span = hi - lo;
    const int c = __syncthreads_count(K[lo + span * (threadIdx.x + 1) / (T + 1)] < key);
    const long long nlo = c > 0 ? lo + span * c / (T + 1) + 1 : lo;   // after probe c - 1
    if (c < T) hi = lo + span * (c + 1) / (T + 1);                     // probe c
    lo = nlo;
  }
  return lo + __syncthreads_count(lo + threadIdx.x < hi && K[lo + threadIdx.x] < key);
}

// grad_out[b, c .. c + 3] in fp32 (/ H for "mean", a divide); VEC: one
// 16-byte (fp32) or 8-byte (bf16) load
template <typename T, bool VEC>
__device__ __forceinline__ void load4(float (&v)[4], const T* __restrict__ g, long long off,
                                      long long sd, int c, int dim) {
  if (VEC) {
    if constexpr (sizeof(T) == 4) {
      const float4 x = *reinterpret_cast<const float4*>(g + off + c);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
      const uint2 raw = *reinterpret_cast<const uint2*>(g + off + c);
      const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = bag::to_f(x[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (c + j < dim) ? bag::to_f(g[off + (c + j) * sd]) : 0.0f;
  }
}

// Evict-first (streaming) stores: a large table's 2 GB of rows would
// otherwise push the sort's keys and grad_out out of the 50 MB L2 while the
// rest of the backward still reads them.
template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ dst, const float (&a)[4], int c,
                                       int dim) {
  if (VEC) {
    __stcs(reinterpret_cast<float4*>(dst + c), make_float4(a[0], a[1], a[2], a[3]));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < dim) __stcs(dst + c + j, a[j]);
  }
}

struct SumArgs {
  const int* K;                             // sorted row keys
  const int* P;                             // their lookup positions b * H + h
  float* dt;                                // (rows, dim) d table
  float* part;                              // (2 * windows, dim) piece sums
  int2* heavy;                              // (windows,) a long row's {first position, row}
                                            // starting there, or {-1, -1}
  const unsigned* hit;                      // (ceil(rows / 32),) bitmap of rows hit
  long long n, windows, sgb, sgd;
  int H, rows, dim, mean, sum_blocks;
};

// a window's warp: sorted positions [t * CHUNK, (t + 1) * CHUNK), one a
// lane.  Each row's piece in the window is summed in lookup order; a row
// whose lookups all lie in the window is written, a piece of a longer row
// goes to slot 2t (the row of the window's first position) or 2t + 1 (its
// last row, which starts inside the window).
template <typename T, bool VEC>
__device__ void sum_window(const SumArgs& a, const T* __restrict__ g, long long t) {
  const int lane = threadIdx.x & 31;
  const long long p0 = t * CHUNK, idx = p0 + lane;
  int kl = a.rows, bl = 0;                  // this lane's row key and bag
  if (idx < a.n) {
    kl = a.K[idx];
    bl = a.P[idx] / a.H;
  }
  const int prev = p0 > 0 ? a.K[p0 - 1] : -1;                    // the row before
  const int next = p0 + CHUNK < a.n ? a.K[p0 + CHUNK] : a.rows;  // and after
  const int cnt = __popc(__ballot_sync(FULL, kl < a.rows));      // a prefix
  int2 heavy = make_int2(-1, -1);
  for (int c0 = 0; c0 < a.dim && cnt > 0; c0 += 128) {
    const int c = c0 + lane * 4;
    const bool mine = c < a.dim;
    int cur = __shfl_sync(FULL, kl, 0), start = 0;   // the open piece: row cur from start
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    auto flush = [&](int stop) {
      const bool before = start == 0 && prev == cur;
      float* dst;
      if (before || (stop == CHUNK && next == cur)) {
        dst = a.part + (2 * t + (start == 0 ? 0 : 1)) * a.dim;
        if (!before) heavy = make_int2((int)(p0 + start), cur);
      } else {
        dst = a.dt + (long long)cur * a.dim;
      }
      if (mine) store4<VEC>(dst, acc, c, a.dim);
    };
    for (int u0 = 0; u0 < cnt; u0 += DEPTH) {
      float v[DEPTH][4];
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) {
        const int b = __shfl_sync(FULL, bl, (u0 + u) & 31);
        if (u0 + u < cnt && mine) load4<T, VEC>(v[u], g, b * a.sgb, a.sgd, c, a.dim);
      }
      if (a.mean) {
#pragma unroll
        for (int u = 0; u < DEPTH; ++u)
#pragma unroll
          for (int j = 0; j < 4; ++j) v[u][j] = v[u][j] / (float)a.H;
      }
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) {
        const int ku = __shfl_sync(FULL, kl, (u0 + u) & 31);
        if (u0 + u >= cnt) continue;
        if (ku != cur) {
          flush(u0 + u);
          cur = ku;
          start = u0 + u;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] += v[u][j];
      }
    }
    flush(cnt);
  }
  if (lane == 0) a.heavy[t] = heavy;
}

// a zero block's warp: the rows of word z of the bitmap that no lookup hit
// get zeros
template <bool VEC>
__device__ void zero_rows(const SumArgs& a, long long z) {
  const int lane = threadIdx.x & 31;
  const long long r0 = z * ZERO_ROWS;
  if (r0 >= a.rows) return;
  const long long nr = min((long long)ZERO_ROWS, a.rows - r0);
  unsigned todo = ~a.hit[z];
  if (nr < 32) todo &= (1u << nr) - 1u;
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  while (todo) {
    const int i = __ffs(todo) - 1;
    todo &= todo - 1;
    float* dst = a.dt + (r0 + i) * a.dim;
    for (int c = lane * 4; c < a.dim; c += 128) store4<VEC>(dst, zero, c, a.dim);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
sum_rows(SumArgs a, const T* __restrict__ g) {
  const long long w = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if ((int)blockIdx.x < a.sum_blocks) {
    if (w < a.windows) sum_window<T, VEC>(a, g, w);
  } else {
    zero_rows<VEC>(a, w - (long long)a.sum_blocks * WARPS);
  }
}

// Block t: the row that starts in window t and runs past it, if any.  Its
// m pieces (one a window it spans) go in GROUPS groups of q = ceil(m /
// GROUPS) consecutive pieces; a warp sums a group in piece order from +0.0,
// then warp 0 adds the groups' sums in group order from +0.0 and writes the
// row.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
combine_heavy(SumArgs a) {
  __shared__ float4 group_sum[GROUPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long t = blockIdx.x;
  const int2 h = a.heavy[t];
  if (h.x < 0) return;
  const long long s = h.x;
  const int r = h.y;
  const long long e = block_lower_bound(a.K, (t + 1) * CHUNK, a.n, (long long)r + 1);
  const long long m = (e - 1) / CHUNK - t + 1, q = (m + GROUPS - 1) / GROUPS;
  const long long k0 = min(m, w * q), k1 = min(m, k0 + q);
  for (int c0 = 0; c0 < a.dim; c0 += 128) {
    const int c = c0 + lane * 4;
    const bool mine = c < a.dim;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (long long kb = k0; kb < k1; kb += DEPTH) {
      float v[DEPTH][4];
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) {
        const long long k = kb + u;
        const long long slot = 2 * (t + k) + ((k == 0 && s % CHUNK != 0) ? 1 : 0);
        if (k < k1 && mine) load4<float, VEC>(v[u], a.part, slot * a.dim, 1, c, a.dim);
      }
#pragma unroll
      for (int u = 0; u < DEPTH; ++u)
        if (kb + u < k1) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] += v[u][j];
        }
    }
    group_sum[w][lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    __syncthreads();
    if (w == 0) {
      float out[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int v = 0; v < GROUPS && v * q < m; ++v) {
        const float4 x = group_sum[v][lane];
        out[0] += x.x; out[1] += x.y; out[2] += x.z; out[3] += x.w;
      }
      if (mine) store4<VEC>(a.dt + (long long)r * a.dim, out, c, a.dim);
    }
    __syncthreads();
  }
}

constexpr long long align256(long long x) { return (x + 255) & ~255LL; }

struct Layout {
  long long keys0, pos0, keys1, pos1, counts, hit, heavy, part, bytes, nb, windows;
};

inline Layout layout(long long n, long long rows, int dim) {
  Layout l;
  l.nb = (n + SORT_TILE - 1) / SORT_TILE;
  l.windows = (n + CHUNK - 1) / CHUNK;
  long long off = 0;
  l.keys0 = off; off += align256(4 * n);
  l.pos0 = off; off += align256(4 * n);
  l.keys1 = off; off += align256(4 * n);
  l.pos1 = off; off += align256(4 * n);
  l.counts = off; off += align256(4LL * MAX_RADIX * l.nb);
  l.hit = off; off += align256(4 * ((rows + 31) / 32));
  l.heavy = off; off += align256(8 * l.windows);
  l.part = off; off += align256(4LL * 2 * l.windows * dim);
  l.bytes = off;
  return l;
}

// A high-priority stream of the current device, made once, for the work that
// runs beside a large table's zero rows.
static cudaStream_t aux_stream() {
  static std::mutex lock;
  static cudaStream_t streams[64] = {};
  int dev = 0, lo = 0, hi = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> guard(lock);
  if (dev < 64 && !streams[dev]) {
    cudaDeviceGetStreamPriorityRange(&lo, &hi);
    cudaStreamCreateWithPriority(&streams[dev], cudaStreamNonBlocking, hi);
  }
  return dev < 64 ? streams[dev] : nullptr;
}

template <typename T, bool VEC>
static int launch(const T* g, long long sgb, long long sgd, Ids ids, float* dt, char* scratch,
                  long long n, int dim, int mean, cudaStream_t stream) {
  const Layout l = layout(n, ids.rows, dim);
  int* keys[2] = {reinterpret_cast<int*>(scratch + l.keys0), reinterpret_cast<int*>(scratch + l.keys1)};
  int* pos[2] = {reinterpret_cast<int*>(scratch + l.pos0), reinterpret_cast<int*>(scratch + l.pos1)};
  int* counts = reinterpret_cast<int*>(scratch + l.counts);
  unsigned* hit = reinterpret_cast<unsigned*>(scratch + l.hit);
  int bits = 0;
  while ((1LL << bits) <= ids.rows) ++bits;           // the key `rows` must fit
  const int passes = (bits + DIGIT_BITS - 1) / DIGIT_BITS;
  const int per = (bits + passes - 1) / passes;
  const unsigned nb = (unsigned)l.nb;
  SumArgs a;
  a.K = keys[(passes - 1) % 2];
  a.P = pos[(passes - 1) % 2];
  a.dt = dt;
  a.part = reinterpret_cast<float*>(scratch + l.part);
  a.heavy = reinterpret_cast<int2*>(scratch + l.heavy);
  a.hit = hit;
  a.n = n;
  a.windows = l.windows;
  a.sgb = sgb;
  a.sgd = sgd;
  a.H = ids.H;
  a.rows = ids.rows;
  a.dim = dim;
  a.mean = mean;
  a.sum_blocks = (int)((l.windows + WARPS - 1) / WARPS);
  const long long zero_blocks =
      ((long long)ids.rows + (long long)ZERO_ROWS * WARPS - 1) / ((long long)ZERO_ROWS * WARPS);
  // A large table's zero rows (bandwidth) run on the caller's stream beside
  // the sort, the windows and the combine (latency) on a high-priority
  // stream, from when pass 0's counts have set the bitmap of rows hit; the
  // caller's stream then waits for both.
  const bool split = (long long)ids.rows * dim * 4 >= SPLIT_BYTES;
  cudaStream_t work = stream;
  cudaEvent_t fork = nullptr, join = nullptr;
  int err;
  if (split) {
    const long long words = ((long long)ids.rows + 31) / 32;
    const long long clear_blocks = (words + THREADS - 1) / THREADS;
    clear_hit<<<(unsigned)(clear_blocks < 1024 ? clear_blocks : 1024), THREADS, 0, stream>>>(
        hit, words);
    if ((err = (int)cudaGetLastError())) return err;
  }
  static bool scan_smem_set[64] = {};       // the scan's dynamic shared memory, once a device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !scan_smem_set[dev]) {
    err = (int)cudaFuncSetAttribute(scan_counts, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    SCAN_SMEM);
    if (err) return err;
    if (dev < 64) scan_smem_set[dev] = true;
  }
  for (int p = 0; p < passes; ++p) {
    // digits (key >> shift) & mask of per bits; the last pass has only
    // (rows >> shift) + 1 of them
    const int shift = p * per, mask = (1 << per) - 1;
    const int radix = p + 1 < passes ? 1 << per : (ids.rows >> shift) + 1;
    const int* kin = keys[(p + 1) % 2];
    const int* pin = pos[(p + 1) % 2];
    if (p == 0)
      digit_counts<true><<<nb, THREADS, 0, work>>>(ids, nullptr, counts, hit, n, l.nb, shift,
                                                   mask, radix, split ? 1 : 0);
    else
      digit_counts<false><<<nb, THREADS, 0, work>>>(ids, kin, counts, hit, n, l.nb, shift,
                                                    mask, radix, 0);
    if ((err = (int)cudaGetLastError())) return err;
    if (p == 0 && split) {
      if (!(work = aux_stream())) return (int)cudaErrorInvalidDevice;
      if ((err = (int)cudaEventCreateWithFlags(&fork, cudaEventDisableTiming))) return err;
      if ((err = (int)cudaEventCreateWithFlags(&join, cudaEventDisableTiming))) return err;
      cudaEventRecord(fork, stream);
      cudaStreamWaitEvent(work, fork, 0);
      SumArgs z = a;
      z.sum_blocks = 0;
      sum_rows<T, VEC><<<(unsigned)zero_blocks, THREADS, 0, stream>>>(z, g);
      if ((err = (int)cudaGetLastError())) return err;
    }
    scan_counts<<<1, SCAN_THREADS, SCAN_SMEM, work>>>(counts, (long long)radix * l.nb);
    if ((err = (int)cudaGetLastError())) return err;
    if (p == 0)
      scatter_digits<true><<<nb, THREADS, 0, work>>>(ids, nullptr, nullptr, counts, keys[0],
                                                     pos[0], hit, n, l.nb, shift, mask,
                                                     radix, split ? 0 : 1);
    else
      scatter_digits<false><<<nb, THREADS, 0, work>>>(ids, kin, pin, counts, keys[p % 2],
                                                      pos[p % 2], hit, n, l.nb, shift, mask,
                                                      radix, 0);
    if ((err = (int)cudaGetLastError())) return err;
  }
  sum_rows<T, VEC><<<(unsigned)(a.sum_blocks + (split ? 0 : zero_blocks)), THREADS, 0, work>>>(
      a, g);
  if ((err = (int)cudaGetLastError())) return err;
  combine_heavy<VEC><<<(unsigned)l.windows, THREADS, 0, work>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  if (split) {
    cudaEventRecord(join, work);
    cudaStreamWaitEvent(stream, join, 0);
    cudaEventDestroy(fork);
    cudaEventDestroy(join);
    err = (int)cudaGetLastError();
  }
  return err;
}

}  // namespace bag_bwd

// Bytes of scratch the backward needs for n = B * H lookups into a table of
// rows rows at width dim.
extern "C" long long embedding_bag_backward_scratch(long long n, long long rows, int dim) {
  return bag_bwd::layout(n, rows, dim).bytes;
}

// g: grad_out, (B, dim) fp32 (dtype 0) or bf16 (1) with element strides
// (sgb, sgd); ids: (B, H) int32 with element strides (sib, sih); dt: the
// (rows, dim) fp32 gradient, every row of which the kernels write;
// scratch: embedding_bag_backward_scratch(B * H, dim) bytes, 256-byte
// aligned.  vec = 1 promises dim % 4 == 0, sgd == 1, sgb % 4 == 0 and g
// aligned to 4 elements.
extern "C" int embedding_bag_backward_launch(const void* g, int dtype, long long sgb,
                                             long long sgd, const void* ids, long long sib,
                                             long long sih, void* dt, void* scratch,
                                             long long B, int H, long long rows, int dim,
                                             int mean, int vec, void* stream) {
  const long long n = B * H;
  if (B < 1 || H < 1 || rows < 1 || rows > 0x7ffffffeLL || dim < 1 || n > 0x7fffffffLL ||
      dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bag_bwd::Ids i{static_cast<const int*>(ids), sib, sih, H, (int)rows};
  float* d = static_cast<float*>(dt);
  char* sc = static_cast<char*>(scratch);
  if (dtype == 1) {
    const __nv_bfloat16* gg = static_cast<const __nv_bfloat16*>(g);
    if (vec) return bag_bwd::launch<__nv_bfloat16, true>(gg, sgb, sgd, i, d, sc, n, dim, mean, s);
    return bag_bwd::launch<__nv_bfloat16, false>(gg, sgb, sgd, i, d, sc, n, dim, mean, s);
  }
  const float* gg = static_cast<const float*>(g);
  if (vec) return bag_bwd::launch<float, true>(gg, sgb, sgd, i, d, sc, n, dim, mean, s);
  return bag_bwd::launch<float, false>(gg, sgb, sgd, i, d, sc, n, dim, mean, s);
}
