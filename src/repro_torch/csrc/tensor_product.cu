// NequIP's edge tensor product for Hopper (sm_90a): the messages of one
// interaction block and their gradient.
//
// It replaces no TPU kernel.  The reference computes the messages with jnp
// einsums that XLA fuses (src/repro/models/gnn/nequip.py:257, `messages`
// in _interact_inner_tp; the same paths in _interact at :124-146), and takes
// their gradient by autodiff.  In PyTorch those einsums are ~150 separate
// passes over (edges, channels) arrays a chunk: ~2 TB of traffic a layer at
// ogb_products (61.9M edges), so the port fuses them here.
//
// Layout (component-major, channels last, fp32, contiguous):
//   x   (E, 13, h)  the sender's features: s, v_0..2, t_00..t_22 (t_ij at 4 + 3i + j)
//   w   (E, 11, h)  the radial weights, in _PATHS order:
//                   ss vv_s sv vs vv_v tv_v vt_v st vv_t ts tt_t
//   r   (E, 3)      rhat, the unit edge vector
//   y   (E, 9)      y2, sym-traceless(rhat rhat^T), row-major
//   m   (E, 13, h)  the messages, in x's layout
// With ST(a) = (a + a^T) / 2 - tr(a) / 3 I, per edge and channel:
//   m_s   = w_ss s + w_vvs (v . r)
//   m_v   = w_sv s r + w_vs v + w_vvv (v x r) + w_tvv (t r) + w_vtv (y v)
//   m_t   = w_st s y + w_ts t + w_vvt ST(v r^T) + w_ttt ST(t y)
// The backward takes g = dL/dm and writes dL/dx and dL/dw in the same
// layouts and, when asked, dL/dr (E, 3) and dL/dy (E, 9) summed over the
// channels.  ST is self-adjoint and gives symmetric matrices, so with
// G = ST(g_t):
//   ds = w_ss g_s + w_sv (g_v . r) + w_st (g_t : y)
//   dv = w_vvs g_s r + w_vs g_v + w_vvv (r x g_v) + w_vtv (y^T g_v) + w_vvt (G r)
//   dt = w_tvv g_v r^T + w_ts g_t + w_ttt (G y^T)
//   dr = w_vvs g_s v + w_sv s g_v + w_vvv (g_v x v) + w_tvv (t^T g_v) + w_vvt (G v)
//   dy = w_vtv g_v v^T + w_st s g_t + w_ttt (t^T G)
// and each dw_p is g's contraction with its path's message term.
//
// Bound on an H100: bytes.  A forward moves 13 + 11 + 13 floats a channel
// and 12 an edge (ogb_products, h = 32: 4.8 KB an edge, 1.4 ms a chunk of
// 262,144 edges at 3.35 TB/s) for ~110 flops a channel; the backward
// 13 + 11 + 13 in and 13 + 11 out.
//
// Design (simple first): one warp an edge, a lane a channel (lanes stride
// the channels when h > 32), so each of a lane's 13 / 11 loads and stores is
// one 128-byte transaction across the warp at h = 32; the edge's r and y are
// read by every lane (one L1 line).  Everything else stays in registers.
// The backward's dr and dy are summed over the channels by each lane over
// its channels in order, then by a fixed xor-butterfly of __shfl_xor_sync,
// and stored by lane 0: no atomics, so two calls give the same bits.
// ref.py's tensor_product_plain is the same function in PyTorch ops.

#include <cuda_runtime.h>
#include <stdint.h>

namespace tp {

constexpr int WARPS = 8;                  // edges a block
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

enum { SS, VVS, SV, VS, VVV, TVV, VTV, ST, VVT, TS, TTT, NPATHS };

struct Edge {
  float r[3], y[3][3];
};

__device__ __forceinline__ Edge load_edge(const float* __restrict__ r,
                                          const float* __restrict__ y, long long e) {
  Edge g;
#pragma unroll
  for (int i = 0; i < 3; ++i) g.r[i] = r[e * 3 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) g.y[i][j] = y[e * 9 + 3 * i + j];
  return g;
}

// sym-traceless part of a 3 x 3 matrix, in place
__device__ __forceinline__ void sym_traceless(float (&a)[3][3]) {
  const float tr = a[0][0] + a[1][1] + a[2][2];
  float b[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) b[i][j] = 0.5f * (a[i][j] + a[j][i]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) a[i][j] = b[i][j];
    a[i][i] -= tr / 3.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
forward_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ r, const float* __restrict__ y,
               float* __restrict__ m, long long E, int h) {
  const int lane = threadIdx.x & 31;
  const long long e = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (e >= E) return;
  const Edge g = load_edge(r, y, e);
  const float* xe = x + e * 13 * h;
  const float* we = w + e * NPATHS * h;
  float* me = m + e * 13 * h;
  for (int c = lane; c < h; c += 32) {
    float wp[NPATHS];
#pragma unroll
    for (int p = 0; p < NPATHS; ++p) wp[p] = we[p * h + c];
    const float s = xe[c];
    float v[3], t[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) v[i] = xe[(1 + i) * h + c];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) t[i][j] = xe[(4 + 3 * i + j) * h + c];
    const float vr = v[0] * g.r[0] + v[1] * g.r[1] + v[2] * g.r[2];
    me[c] = wp[SS] * s + wp[VVS] * vr;
    const float cr[3] = {v[1] * g.r[2] - v[2] * g.r[1], v[2] * g.r[0] - v[0] * g.r[2],
                         v[0] * g.r[1] - v[1] * g.r[0]};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float tr = t[i][0] * g.r[0] + t[i][1] * g.r[1] + t[i][2] * g.r[2];
      const float yv = g.y[i][0] * v[0] + g.y[i][1] * v[1] + g.y[i][2] * v[2];
      me[(1 + i) * h + c] = wp[SV] * (s * g.r[i]) + wp[VS] * v[i] + wp[VVV] * cr[i] +
                            wp[TVV] * tr + wp[VTV] * yv;
    }
    float o[3][3], ty[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        o[i][k] = v[i] * g.r[k];
        ty[i][k] = t[i][0] * g.y[0][k] + t[i][1] * g.y[1][k] + t[i][2] * g.y[2][k];
      }
    sym_traceless(o);
    sym_traceless(ty);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        me[(4 + 3 * i + j) * h + c] = wp[ST] * (s * g.y[i][j]) + wp[TS] * t[i][j] +
                                      wp[VVT] * o[i][j] + wp[TTT] * ty[i][j];
  }
}

__global__ void __launch_bounds__(THREADS)
backward_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ r, const float* __restrict__ y,
                const float* __restrict__ gm, float* __restrict__ dx,
                float* __restrict__ dw, float* __restrict__ dr, float* __restrict__ dy,
                long long E, int h) {
  const int lane = threadIdx.x & 31;
  const long long e = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (e >= E) return;
  const Edge g = load_edge(r, y, e);
  const float* xe = x + e * 13 * h;
  const float* we = w + e * NPATHS * h;
  const float* ge = gm + e * 13 * h;
  float* dxe = dx + e * 13 * h;
  float* dwe = dw + e * NPATHS * h;
  float acc_r[3] = {0.f, 0.f, 0.f};
  float acc_y[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  for (int c = lane; c < h; c += 32) {
    float wp[NPATHS];
#pragma unroll
    for (int p = 0; p < NPATHS; ++p) wp[p] = we[p * h + c];
    const float s = xe[c], gs = ge[c];
    float v[3], gv[3], t[3][3], gt[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      v[i] = xe[(1 + i) * h + c];
      gv[i] = ge[(1 + i) * h + c];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        t[i][j] = xe[(4 + 3 * i + j) * h + c];
        gt[i][j] = ge[(4 + 3 * i + j) * h + c];
      }
    float G[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) G[i][j] = gt[i][j];
    sym_traceless(G);
    const float vr = v[0] * g.r[0] + v[1] * g.r[1] + v[2] * g.r[2];
    const float gvr = gv[0] * g.r[0] + gv[1] * g.r[1] + gv[2] * g.r[2];
    const float gvv = gv[0] * v[0] + gv[1] * v[1] + gv[2] * v[2];
    float gty = 0.f, gtt = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        gty += gt[i][j] * g.y[i][j];
        gtt += gt[i][j] * t[i][j];
      }
    const float cr[3] = {v[1] * g.r[2] - v[2] * g.r[1], v[2] * g.r[0] - v[0] * g.r[2],
                         v[0] * g.r[1] - v[1] * g.r[0]};
    float tr[3], yv[3], Gr[3], Gv[3], tg[3], ytg[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      tr[i] = t[i][0] * g.r[0] + t[i][1] * g.r[1] + t[i][2] * g.r[2];
      yv[i] = g.y[i][0] * v[0] + g.y[i][1] * v[1] + g.y[i][2] * v[2];
      Gr[i] = G[i][0] * g.r[0] + G[i][1] * g.r[1] + G[i][2] * g.r[2];
      Gv[i] = G[i][0] * v[0] + G[i][1] * v[1] + G[i][2] * v[2];
      tg[i] = t[0][i] * gv[0] + t[1][i] * gv[1] + t[2][i] * gv[2];      // t^T g_v
      ytg[i] = g.y[0][i] * gv[0] + g.y[1][i] * gv[1] + g.y[2][i] * gv[2];  // y^T g_v
    }
    float ty[3][3];
    float gtyt = 0.f;                     // G : (t y)
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        ty[i][k] = t[i][0] * g.y[0][k] + t[i][1] * g.y[1][k] + t[i][2] * g.y[2][k];
        gtyt += G[i][k] * ty[i][k];
      }
    // dL/dw
    dwe[SS * h + c] = gs * s;
    dwe[VVS * h + c] = gs * vr;
    dwe[SV * h + c] = s * gvr;
    dwe[VS * h + c] = gvv;
    dwe[VVV * h + c] = gv[0] * cr[0] + gv[1] * cr[1] + gv[2] * cr[2];
    dwe[TVV * h + c] = gv[0] * tr[0] + gv[1] * tr[1] + gv[2] * tr[2];
    dwe[VTV * h + c] = gv[0] * yv[0] + gv[1] * yv[1] + gv[2] * yv[2];
    dwe[ST * h + c] = s * gty;
    dwe[VVT * h + c] = v[0] * Gr[0] + v[1] * Gr[1] + v[2] * Gr[2];
    dwe[TS * h + c] = gtt;
    dwe[TTT * h + c] = gtyt;
    // dL/dx
    dxe[c] = wp[SS] * gs + wp[SV] * gvr + wp[ST] * gty;
    const float rg[3] = {g.r[1] * gv[2] - g.r[2] * gv[1], g.r[2] * gv[0] - g.r[0] * gv[2],
                         g.r[0] * gv[1] - g.r[1] * gv[0]};           // r x g_v
#pragma unroll
    for (int i = 0; i < 3; ++i)
      dxe[(1 + i) * h + c] = wp[VVS] * gs * g.r[i] + wp[VS] * gv[i] + wp[VVV] * rg[i] +
                             wp[VTV] * ytg[i] + wp[VVT] * Gr[i];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float gyt = G[i][0] * g.y[j][0] + G[i][1] * g.y[j][1] + G[i][2] * g.y[j][2];
        dxe[(4 + 3 * i + j) * h + c] =
            wp[TVV] * gv[i] * g.r[j] + wp[TS] * gt[i][j] + wp[TTT] * gyt;
      }
    if (dr != nullptr) {
      const float gx[3] = {gv[1] * v[2] - gv[2] * v[1], gv[2] * v[0] - gv[0] * v[2],
                           gv[0] * v[1] - gv[1] * v[0]};             // g_v x v
#pragma unroll
      for (int i = 0; i < 3; ++i)
        acc_r[i] += wp[VVS] * gs * v[i] + wp[SV] * s * gv[i] + wp[VVV] * gx[i] +
                    wp[TVV] * tg[i] + wp[VVT] * Gv[i];
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float tG = t[0][j] * G[0][k] + t[1][j] * G[1][k] + t[2][j] * G[2][k];
          acc_y[j][k] += wp[VTV] * gv[j] * v[k] + wp[ST] * s * gt[j][k] + wp[TTT] * tG;
        }
    }
  }
  if (dr == nullptr) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 3; ++i) acc_r[i] += __shfl_xor_sync(FULL, acc_r[i], off);
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) acc_y[j][k] += __shfl_xor_sync(FULL, acc_y[j][k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) dr[e * 3 + i] = acc_r[i];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) dy[e * 9 + 3 * j + k] = acc_y[j][k];
  }
}

inline unsigned blocks(long long E) { return (unsigned)((E + WARPS - 1) / WARPS); }

}  // namespace tp

// Every pointer is a contiguous fp32 array of the layout above; E >= 1,
// 1 <= h, and (E + 7) / 8 < 2^31.
extern "C" int tensor_product_launch(const void* x, const void* w, const void* r,
                                     const void* y, void* m, long long E, int h,
                                     void* stream) {
  if (E < 1 || h < 1 || (E + tp::WARPS - 1) / tp::WARPS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  tp::forward_kernel<<<tp::blocks(E), tp::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(r), static_cast<const float*>(y), static_cast<float*>(m), E, h);
  return (int)cudaGetLastError();
}

// dr and dy are both null (no geometry gradient) or both given.
extern "C" int tensor_product_backward_launch(const void* x, const void* w, const void* r,
                                              const void* y, const void* g, void* dx,
                                              void* dw, void* dr, void* dy, long long E,
                                              int h, void* stream) {
  if (E < 1 || h < 1 || (E + tp::WARPS - 1) / tp::WARPS > 0x7fffffffLL ||
      (dr == nullptr) != (dy == nullptr))
    return (int)cudaErrorInvalidValue;
  tp::backward_kernel<<<tp::blocks(E), tp::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(r), static_cast<const float*>(y),
      static_cast<const float*>(g), static_cast<float*>(dx), static_cast<float*>(dw),
      static_cast<float*>(dr), static_cast<float*>(dy), E, h);
  return (int)cudaGetLastError();
}
