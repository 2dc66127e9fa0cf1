// Blocked online-softmax attention for Hopper (sm_90a).
//
// Replaces the TPU kernel _flash_kernel
// (src/repro/kernels/flash_attention/kernel.py:26, launched by
// flash_attention at :91): q (B, Lq, H, hd) against k, v (B, Lk, KV, hd),
// fp32 (m, l, acc) running state over key tiles, GQA by reading KV head
// h / (H / KV) for query head h (no KV copy in memory), the right-aligned
// causal mask (q_offset = Lk - Lq) and a per-example valid length
// limit = min(Lk, kv_lens[b]); an example of length 0 gives zeros
// (acc / (l + 1e-30) with l = acc = 0), as the Pallas kernel does.
//
// Bound on an H100.  At the cross-encoder shape (L = 64, H = 8, KV = 4,
// hd = 32, 64 pairs a micro-batch, 43 valid keys each) one call moves
// ~6 MB in bf16 and does ~2e8 FLOP: bytes and the launch itself bound it
// (microseconds).  At the
// Qwen3-8B attention shape (B = 2, L = 2048, H = 32, KV = 8, hd = 128, bf16)
// it is operations: ~1.4e11 FLOP against ~84 MB.
//
// What the design does about it (simple first): one block per (batch*head,
// 64-row query tile), 256 threads, four per query row; lane l of a row keeps
// dims l, l+4, ... of q and of the fp32 accumulator in registers.  K and V
// tiles of 64 keys are staged in shared memory as fp32 (converted once on
// load); every row reads the same key, so the four lanes of a row read four
// neighbouring words and the eight rows of a warp share them (no bank
// conflicts).  A row's dot product is finished with two xor-shuffles.  The
// online softmax steps over 16 keys at a time, so a thread keeps 16 logits
// in registers, not 64 (fewer registers, more blocks in flight).  Key tiles
// (and 16-key steps) past the example's valid length, or wholly above the
// causal diagonal, are not touched (masked keys change nothing in the
// online softmax).  All math is fp32 on the CUDA cores: no tensor cores,
// no TMA, no pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr int BQ = 64;                  // query rows per block
constexpr int BK = 64;                  // keys per shared-memory tile
constexpr int SUB = 16;                 // keys per online-softmax step
constexpr int LANES = 4;                // threads per query row
constexpr int THREADS = BQ * LANES;
constexpr float NEG_INF_F = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
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
  const T* qp = q + b * q_sb + (long long)qi * q_sl + h * q_sh;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    qr[i] = qi < Lq ? to_f(qp[lane + LANES * i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF_F, l = 0.f;
  const T* kb = k + b * k_sb + g * k_sh;
  const T* vb = v + b * v_sb + g * v_sh;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();                    // the previous tile is consumed
    for (int e = threadIdx.x; e < BK * HD; e += THREADS) {
      const int kj = k0 + e / HD, d = e % HD;
      const bool in = kj < kend;        // later keys are masked for every row
      s_k[e] = in ? to_f(kb[kj * k_sl + d]) : 0.f;
      s_v[e] = in ? to_f(vb[kj * v_sl + d]) : 0.f;
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
    T* op = out + (((long long)b * Lq + qi) * H + h) * HD;
    const float den = l + 1e-30f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) op[lane + LANES * i] = from_f<T>(acc[i] / den);
  }
}

template <typename T, int HD>
static int launch(const void* q, const void* k, const void* v, void* out,
                  const int* kv_lens, int B, int Lq, int Lk, int H, int KV,
                  const long long* st, int causal, float scale,
                  cudaStream_t stream) {
  const int smem = 2 * BK * HD * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B * H, (Lq + BQ - 1) / BQ);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), kv_lens, H, KV, Lq, Lk, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                       void* out, const int* kv_lens, int B, int Lq, int Lk,
                       int H, int KV, const long long* st, int causal,
                       float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, kv_lens, B, Lq, Lk, H, KV, st, causal, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, kv_lens, B, Lq, Lk, H, KV, st, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, kv_lens, B, Lq, Lk, H, KV, st, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, kv_lens, B, Lq, Lk, H, KV, st, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace flash

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).  Strides are in
// elements, for the batch, sequence and head axes (the last axis is
// contiguous); out is a contiguous (B, Lq, H, hd) tensor.  kv_lens may be
// null (every example is Lk long).
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
  if (dtype == 1)
    return flash::dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, kv_lens, B, Lq, Lk,
                                             H, KV, st, causal, scale, s);
  return flash::dispatch_hd<float>(hd, q, k, v, out, kv_lens, B, Lq, Lk, H, KV, st,
                                   causal, scale, s);
}
