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
// What the design does about it (simple first): one warp per bag, eight
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
