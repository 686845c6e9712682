// The device code of K6's chain (block_bwd.cu) and of its phases split over
// a space group (block_bwd_split.cu): the pre-activation's cotangent and
// its sums' source, the dy2 pass, and the chain's convs and weight
// gradients by dtype.
#pragma once

#include "conv_dw.cuh"
#include "conv3x3_dw_tc.cuh"
#include "conv3x3_tc.cuh"
#include "instnorm_bwd.cuh"

namespace smsut {

// gp, xh2 (and xhs) of element e of the block's output; NS summands
// gp, gp*xh2 (, gp*xhs) for the sums pass.
template <typename T_, bool SHORT> struct BlockOutSrc {
  typedef T_ T;
  static constexpr int NS = SHORT ? 3 : 2;
  const T* g;
  const T* y2;
  const T* idn;        // x (identity form) or u (shortcut form)
  const float* gh2;    // [B][2][C]
  const float* ghs;    // [B][2][C], shortcut form
  const float* m2;     // [B][C]
  const float* r2;
  const float* ms;
  const float* rs;
  int HW, C;

  // gp, xh2 and xhs of one element from its g, y2 and idn and its
  // channel's (g, h) of norm 2 and the shortcut's norm, and their mean and
  // rstd
  __device__ __forceinline__ static void parts(float gv, float y2v, float iv,
                                               float g2, float h2, float gs,
                                               float hs, float m2v, float r2v,
                                               float msv, float rsv, float& gp,
                                               float& xh2, float& xhs) {
    float pre = mul_add_rn(y2v, g2, h2);
    if (SHORT) {
      pre = __fadd_rn(pre, mul_add_rn(iv, gs, hs));
      xhs = __fmul_rn(__fsub_rn(iv, msv), rsv);
    } else {
      pre = __fadd_rn(pre, iv);
      xhs = 0.f;
    }
    gp = gv * lrelu_grad(pre);
    xh2 = __fmul_rn(__fsub_rn(y2v, m2v), r2v);
  }
  __device__ __forceinline__ void parts(float gv, float y2v, float iv, int b,
                                        int c, float& gp, float& xh2,
                                        float& xhs) const {
    const int bc = b * C + c;
    const float* G2 = gh2 + (size_t)2 * b * C;
    const float* GS = SHORT ? ghs + (size_t)2 * b * C : nullptr;
    parts(gv, y2v, iv, G2[c], G2[C + c], SHORT ? GS[c] : 0.f,
          SHORT ? GS[C + c] : 0.f, m2[bc], r2[bc], SHORT ? ms[bc] : 0.f,
          SHORT ? rs[bc] : 0.f, gp, xh2, xhs);
  }
  // the constants of V channels from c of sample b
  template <int V> struct Chan {
    float g2[V], h2[V], gs[V], hs[V], m2[V], r2[V], ms[V], rs[V];
    __device__ __forceinline__ Chan(const BlockOutSrc& src, int b, int c) {
      const int C = src.C;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int bc = b * C + c + k;
        g2[k] = src.gh2[(size_t)2 * b * C + c + k];
        h2[k] = src.gh2[(size_t)2 * b * C + C + c + k];
        m2[k] = src.m2[bc];
        r2[k] = src.r2[bc];
        gs[k] = SHORT ? src.ghs[(size_t)2 * b * C + c + k] : 0.f;
        hs[k] = SHORT ? src.ghs[(size_t)2 * b * C + C + c + k] : 0.f;
        ms[k] = SHORT ? src.ms[bc] : 0.f;
        rs[k] = SHORT ? src.rs[bc] : 0.f;
      }
    }
  };
  template <bool VEC>
  __device__ __forceinline__ void unit(
      const Chan<NormUnit<T, VEC>::V>& ch, int b, int px, int c,
      float (&v)[NS][NormUnit<T, VEC>::V]) const {
    constexpr int V = NormUnit<T, VEC>::V;
    const size_t e = ((size_t)b * HW + px) * C + c;
    float gv[V], yv[V], iv[V];
    NormUnit<T, VEC>::load(g + e, gv);
    NormUnit<T, VEC>::load(y2 + e, yv);
    NormUnit<T, VEC>::load(idn + e, iv);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float gp, xh2, xhs;
      parts(gv[k], yv[k], iv[k], ch.g2[k], ch.h2[k], ch.gs[k], ch.hs[k],
            ch.m2[k], ch.r2[k], ch.ms[k], ch.rs[k], gp, xh2, xhs);
      v[0][k] = gp;
      v[1][k] = gp * xh2;
      if (SHORT) v[NS - 1][k] = gp * xhs;
    }
  }
};

// dy2 (T), and du (T, shortcut form) or gp (float32, identity form); the
// norms' means over n pixels (the map's, or the image's under a space group)
template <typename T, bool SHORT>
__global__ void __launch_bounds__(256)
block_dy2_kernel(BlockOutSrc<T, SHORT> src, const float* __restrict__ sums,
                 const float* __restrict__ s2, const float* __restrict__ ss,
                 T* __restrict__ dy2, T* __restrict__ du,
                 float* __restrict__ gpf, long long n4, float n) {
  constexpr int NS = BlockOutSrc<T, SHORT>::NS;
  const int C = src.C;
  const long long HWC = (long long)src.HW * C;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * 4;
    const int b = (int)(e / HWC);
    const int c = (int)(e % C);
    float gv[4], yv[4], iv[4], o2[4], os[4];
    load4(src.g + e, gv);
    load4(src.y2 + e, yv);
    load4(src.idn + e, iv);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int bc = b * C + c + k;
      float gp, xh2, xhs;
      src.parts(gv[k], yv[k], iv[k], b, c + k, gp, xh2, xhs);
      const float* S = sums + (size_t)b * NS * C + c + k;
      const float cd = S[0] / n;
      o2[k] = (s2[c + k] * src.r2[bc]) *
              (round_to<T>(gp) - cd - xh2 * (S[C] / n));
      if (SHORT)
        os[k] = (ss[c + k] * src.rs[bc]) *
                (gp - cd - xhs * (S[(NS - 1) * C] / n));
      else
        os[k] = gp;
    }
    store4(dy2 + e, o2);
    if (SHORT)
      store4(du + e, os);
    else
      store4(gpf + e, os);
  }
}

// The packed map's norm sums (groups G > 1, channel s*(C/G) + c): rows
// [R][C] of per-sample sums become, at every member of each original
// channel, the sum of its G groups in the order s = 0 .. G-1.  In place:
// each thread reads and writes the G entries of one (row, channel).
__global__ void pool_group_sums_kernel(float* __restrict__ sums, int R,
                                       int C, int G) {
  const int Cg = C / G;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)R * Cg) return;
  float* p = sums + (size_t)(i / Cg) * C + i % Cg;
  float t = p[0];
  for (int q = 1; q < G; ++q) t += p[(size_t)q * Cg];
  for (int q = 0; q < G; ++q) p[(size_t)q * Cg] = t;
}

inline cudaError_t pool_group_sums(float* sums, int R, int C, int G,
                                   cudaStream_t s) {
  if (G == 1) return cudaSuccess;
  const long long n = (long long)R * (C / G);
  pool_group_sums_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      sums, R, C, G);
  return cudaGetLastError();
}

// The convolutions of the chain, by dtype: float32 on the CUDA cores,
// bfloat16 on the tensor cores.  The weight gradient corr(x, g) (with PRO,
// x = norm_act(x) while staging, gh the (g, h) of x's norm):
// With WIN, x holds hin rows at the row offset off and H is g's (y's) rows
// (the row window of a space rank's rows with their halos).
template <int KS, bool PRO, bool WIN = false>
static cudaError_t bwd_dw(const float* x, const float* g, const float* gh,
                          float* part, float* dw, int B, int H, int W, int C,
                          int Cout, cudaStream_t s, int hin = 0,
                          int off = 0) {
  return launch_dw<float, KS, PRO, WIN>(x, g, gh, part, dw, B, H, W, C, Cout,
                                        s, hin, off);
}
template <int KS, bool PRO, bool WIN = false>
static cudaError_t bwd_dw(const bf16* x, const bf16* g, const float* gh,
                          float* part, float* dw, int B, int H, int W, int C,
                          int Cout, cudaStream_t s, int hin = 0,
                          int off = 0) {
  return conv3x3_dw_tc<KS, PRO, WIN>(x, g, part, dw, B, H, W, C, Cout, s,
                                     kDwTcTarget, gh, hin, off);
}
// y = conv(x, w) with the epilogue EPI (its map epi, and epi_gh for
// kEpiMask):
template <int KS, typename OutT, int EPI, bool WIN = false>
static cudaError_t bwd_conv(const float* x, const float* w, OutT* y,
                            const void* epi, const float* epi_gh, int B,
                            int H, int W, int C, int Cout, cudaStream_t s,
                            int hin = 0, int off = 0) {
  return launch_conv_ex<float, OutT, KS, false, false, EPI, WIN>(
      x, w, y, nullptr, nullptr, epi, epi_gh, B, H, W, C, Cout, s, hin, off);
}
template <int KS, typename OutT, int EPI, bool WIN = false>
static cudaError_t bwd_conv(const bf16* x, const bf16* w, OutT* y,
                            const void* epi, const float* epi_gh, int B,
                            int H, int W, int C, int Cout, cudaStream_t s,
                            int hin = 0, int off = 0) {
  return conv3x3_tc<KS, OutT, false, false, EPI, WIN>(
      x, w, y, B, H, W, C, Cout, s, -1,
      TcOpts{nullptr, nullptr, epi, epi_gh, hin, off});
}

}  // namespace smsut
