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
// of grad_out[b] (or grad_out[b] / H for "mean"), written into a dense fp32
// (rows, dim) array that the wrapper zeroes; an id outside [-rows, rows)
// gives nothing (jnp.take's gather drops it from the scatter-add).
//
// Deterministic: no atomics.  The wrapper sorts the lookups' row keys
// stably (a key of rows marks a dropped id), so each row's lookups lie
// together in lookup order.  Pass A: one warp per tile of TILE sorted
// lookups sums each run of equal keys in that order; a run that starts and
// ends in its tile is its row's whole gradient and is written straight to
// d table, a run cut by the tile's first or last edge goes to that tile's
// head or tail partial.  Pass B: the tile where a cut run starts adds the
// following tiles' head partials to its tail partial in tile order and
// writes the row.  Every row is written by one warp, in an order fixed by
// the ids alone, so two calls give the same bits.
//
// Bound on an H100: bytes, as the forward: grad_out and the ids read once,
// each touched row written once (a row of a small table is hit by
// thousands of lookups and written once).  The lookups of a tile read
// grad_out rows at random (a bag's row is read once per lookup), from L2
// where grad_out fits in it (DLRM at B = 65,536, dim 128: 33.5 MB).
// ---------------------------------------------------------------------------

namespace bag_bwd {

constexpr int WARPS = 8;                  // tiles per block
constexpr int THREADS = WARPS * 32;

template <bool VEC16>
__device__ __forceinline__ void add_row(float (&acc)[4], const float* __restrict__ row,
                                        int c, int dim, int H, int mean) {
  float v[4];
  if (VEC16) {
    const float4 raw = *reinterpret_cast<const float4*>(row + c);
    v[0] = raw.x; v[1] = raw.y; v[2] = raw.z; v[3] = raw.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (c + j < dim) ? row[c + j] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] += mean ? v[j] / (float)H : v[j];
}

template <bool VEC16>
__device__ __forceinline__ void store_row(float* __restrict__ dst, const float (&acc)[4],
                                          int c, int dim) {
  if (VEC16) {
    *reinterpret_cast<float4*>(dst + c) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < dim) dst[c + j] = acc[j];
  }
}

template <bool VEC16>
__global__ void __launch_bounds__(THREADS)
partial_kernel(const long long* __restrict__ keys, const long long* __restrict__ perm,
               const float* __restrict__ g, float* __restrict__ dt,
               float* __restrict__ head, float* __restrict__ tail, long long n,
               long long n_tiles, int tile, int H, long long rows, int dim, int mean) {
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= n_tiles) return;
  const long long t0 = t * tile, t1 = min(n, t0 + tile);
  for (int c0 = 0; c0 < dim; c0 += 128) {
    const int c = c0 + lane * 4;
    const bool mine = c < dim;
    long long s = t0;
    while (s < t1) {
      const long long k = keys[s];
      long long e = s + 1;
      while (e < t1 && keys[e] == k) ++e;
      if (k >= rows) break;               // dropped ids sort last
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (mine)
        for (long long i = s; i < e; ++i)
          add_row<VEC16>(acc, g + (perm[i] / H) * (long long)dim, c, dim, H, mean);
      const bool before = s == t0 && t0 > 0 && keys[t0 - 1] == k;
      const bool after = e == t1 && t1 < n && keys[t1] == k;
      float* dst = before ? head + t * (long long)dim
                 : after ? tail + t * (long long)dim
                 : dt + k * (long long)dim;
      if (mine) store_row<VEC16>(dst, acc, c, dim);
      s = e;
    }
  }
}

template <bool VEC16>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const long long* __restrict__ keys, const float* __restrict__ head,
               const float* __restrict__ tail, float* __restrict__ dt, long long n,
               long long n_tiles, int tile, long long rows, int dim) {
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= n_tiles) return;
  const long long t0 = t * tile, t1 = min(n, t0 + tile);
  if (t1 >= n) return;                    // nothing runs past the last tile
  const long long k = keys[t1 - 1];
  if (k >= rows || keys[t1] != k) return; // the tile's last run ends in it
  if (keys[t0] == k && t0 > 0 && keys[t0 - 1] == k) return;   // it began earlier
  for (int c0 = 0; c0 < dim; c0 += 128) {
    const int c = c0 + lane * 4;
    if (c >= dim) continue;
    float acc[4];
    const float* src = tail + t * (long long)dim;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = (c + j < dim) ? src[c + j] : 0.0f;
    for (long long u = t + 1; u < n_tiles; ++u) {
      const float* h = head + u * (long long)dim;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < dim) acc[j] += h[c + j];
      const long long end = min(n, (u + 1) * tile);
      if (end >= n || keys[end] != k) break;
    }
    store_row<VEC16>(dt + k * (long long)dim, acc, c, dim);
  }
}

template <bool VEC16>
static int launch(const long long* keys, const long long* perm, const float* g, float* dt,
                  float* head, float* tail, long long n, int tile, int H, long long rows,
                  int dim, int mean, cudaStream_t stream) {
  const long long n_tiles = (n + tile - 1) / tile;
  const unsigned grid = (unsigned)((n_tiles + WARPS - 1) / WARPS);
  partial_kernel<VEC16><<<grid, THREADS, 0, stream>>>(keys, perm, g, dt, head, tail, n,
                                                      n_tiles, tile, H, rows, dim, mean);
  int err = (int)cudaGetLastError();
  if (err) return err;
  combine_kernel<VEC16><<<grid, THREADS, 0, stream>>>(keys, head, tail, dt, n, n_tiles,
                                                      tile, rows, dim);
  return (int)cudaGetLastError();
}

}  // namespace bag_bwd

// keys: the n = B * H lookups' row keys sorted stably (int64; rows for a
// dropped id), perm: their lookup positions (int64, b * H + h), g:
// grad_out, a contiguous (B, dim) fp32 array; dt: the (rows, dim) fp32
// gradient, zeroed by the caller; head and tail: (ceil(n / tile), dim)
// fp32 scratch.  vec16 = 1 promises dim % 4 == 0 and 16-byte aligned g and
// dt.
extern "C" int embedding_bag_backward_launch(const void* keys, const void* perm,
                                             const void* g, void* dt, void* head,
                                             void* tail, long long n, int tile, int H,
                                             long long rows, int dim, int mean, int vec16,
                                             void* stream) {
  if (n < 1 || tile < 1 || H < 1 || rows < 1 || dim < 1 ||
      ((n + tile - 1) / tile + bag_bwd::WARPS - 1) / bag_bwd::WARPS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* k = static_cast<const long long*>(keys);
  const long long* p = static_cast<const long long*>(perm);
  const float* gg = static_cast<const float*>(g);
  float* d = static_cast<float*>(dt);
  float* hd = static_cast<float*>(head);
  float* tl = static_cast<float*>(tail);
  if (vec16)
    return bag_bwd::launch<true>(k, p, gg, d, hd, tl, n, tile, H, rows, dim, mean, s);
  return bag_bwd::launch<false>(k, p, gg, d, hd, tl, n, tile, H, rows, dim, mean, s);
}
