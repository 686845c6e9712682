// Instance-norm backward device code, NHWC: the device code of K4
// (instnorm_bwd.cu) and of the three norm backwards of K6 (block_bwd.cu).
//
// Per (sample, channel), over the n = H*W pixels, with d the cotangent
// after any activation mask and xhat = (x - mean) * rstd:
//   S_d = sum d,  S_dx = sum d * xhat,
//   dx = scale * rstd * (d - S_d/n - xhat * S_dx/n),
//   dscale = sum_b S_dx,  dbias = sum_b S_d.
//
// K4 takes K1's two-pass plan (instnorm.cuh): norm_sums_kernel, whose last
// blocks also add the batch sums, then the dx pass.  (A resident plan, x and
// g held in a cluster's shared memory, ran 0.0006-0.0023 ms slower than
// these two passes wherever it fitted, 64^2 to 16^2, on the H100:
// tools/norm_plans.cu.)  Each summand comes from a source (NS values per
// element, per-channel constants loaded once per thread), so K6 takes the
// sums pass for its pre-activation cotangent too, whose mask and xhat
// differ.  No float atomics: runs agree bit for bit.
#pragma once

#include "instnorm.cuh"

namespace smsut {

// d and xhat of an element of the instance norm y = xhat*scale + bias, act:
// d = g masked by y >= 0 (the mask of `_make_bwd_kernel`); the mask's y is
// computed with separate roundings.
template <typename T_> struct NormBwdSrc {
  typedef T_ T;
  static constexpr int NS = 2;
  const T* x;
  const T* g;
  const float* mean;   // [B][C]
  const float* rstd;   // [B][C]
  const float* scale;  // [C]
  const float* bias;   // [C], read only with act
  int HW, C, act;

  // mean, rstd, scale and bias of V channels from c of sample b
  template <int V> struct Chan {
    float m[V], r[V], s[V], h[V];
    __device__ __forceinline__ Chan(const NormBwdSrc& src, int b, int c) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        m[k] = src.mean[b * src.C + c + k];
        r[k] = src.rstd[b * src.C + c + k];
        s[k] = src.scale[c + k];
        h[k] = src.act ? src.bias[c + k] : 0.f;
      }
    }
  };
  template <int V>
  __device__ __forceinline__ void d_xh(float xv, float gv, const Chan<V>& ch,
                                       int k, float& d, float& xh) const {
    xh = __fmul_rn(__fsub_rn(xv, ch.m[k]), ch.r[k]);
    d = gv;
    if (act && !(mul_add_rn(xh, ch.s[k], ch.h[k]) >= 0.f)) d = kSlope * gv;
  }
  // the summands d, d*xhat of V channels from their x and g
  template <int V>
  __device__ __forceinline__ void sums(const float (&xv)[V],
                                       const float (&gv)[V],
                                       const Chan<V>& ch,
                                       float (&v)[NS][V]) const {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float d, xh;
      d_xh(xv[k], gv[k], ch, k, d, xh);
      v[0][k] = d;
      v[1][k] = d * xh;
    }
  }
  template <bool VEC>
  __device__ __forceinline__ void unit(
      const Chan<NormUnit<T, VEC>::V>& ch, int b, int px, int c,
      float (&v)[NS][NormUnit<T, VEC>::V]) const {
    constexpr int V = NormUnit<T, VEC>::V;
    const size_t e = ((size_t)b * HW + px) * C + c;
    float xv[V], gv[V];
    NormUnit<T, VEC>::load(x + e, xv);
    NormUnit<T, VEC>::load(g + e, gv);
    sums<V>(xv, gv, ch, v);
  }
  // dx of V channels from their x, g and the sums S [NS][sstride] of their
  // sample, from their first channel
  template <int V>
  __device__ __forceinline__ void dx(const float (&xv)[V],
                                     const float (&gv)[V], const Chan<V>& ch,
                                     const float* S, int sstride,
                                     float (&out)[V]) const {
    const float n = (float)HW;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float d, xh;
      d_xh(xv[k], gv[k], ch, k, d, xh);
      const float a = ch.s[k] * ch.r[k];
      out[k] = a * (d - S[k] / n - xh * (S[sstride + k] / n));
    }
  }
};

// Two-pass, the dx pass: grid (nsplit * ng, B), block (s, gi, b) writes dx
// over its slice from x, g and the sums; thread t keeps unit t % U.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kNormThreads)
norm_bwd_apply_kernel(NormBwdSrc<T> src, const float* __restrict__ sums,
                      T* __restrict__ dx, NormPlan p) {
  using Un = NormUnit<T, VEC>;
  constexpr int V = Un::V;
  const int t = threadIdx.x, C = src.C, U = p.U, TY = kNormThreads / U;
  if (t >= TY * U) return;
  const int s = blockIdx.x % p.nsplit, g0 = blockIdx.x / p.nsplit * p.G;
  const int b = blockIdx.y, c = g0 + (t % U) * V;
  const int p0 = s * p.rows, n = max(0, min(src.HW - p0, p.rows));
  const size_t base = ((size_t)b * src.HW + p0) * C + c;
  const float* S = sums + (size_t)b * 2 * C + c;
  const typename NormBwdSrc<T>::template Chan<V> ch(src, b, c);
  float Sv[2][V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    Sv[0][k] = S[k];
    Sv[1][k] = S[C + k];
  }
#pragma unroll 4
  for (int q = t / U; q < n; q += TY) {
    const size_t o = base + (size_t)q * C;
    float xv[V], gv[V], out[V];
    Un::load(src.x + o, xv);
    Un::load(src.g + o, gv);
    src.template dx<V>(xv, gv, ch, &Sv[0][0], V, out);
    Un::store(dx + o, out);
  }
}

template <typename T>
cudaError_t launch_norm_bwd_apply(const NormBwdSrc<T>& src, const NormPlan& p,
                                  const float* sums, T* dx, int B,
                                  cudaStream_t s) {
  const dim3 grid(p.nsplit * p.ng, B);
  if (p.vec)
    return launch_norm(norm_bwd_apply_kernel<T, true>, grid, 1, 0, s, src,
                       sums, dx, p);
  return launch_norm(norm_bwd_apply_kernel<T, false>, grid, 1, 0, s, src, sums,
                     dx, p);
}

// K4's plan for a shape: two passes over x and g
template <typename T>
inline NormPlan in_bwd_plan(int B, int HW, int C) {
  return norm_two_pass_plan(B, HW, C, sizeof(T), 2, 2);
}

// K4 under plan p: dx, and out [2][C] = (dbias, dscale); scratch:
// norm_scratch_elems(p, B, C, 2) floats; tickets as in norm_sums_kernel.
template <typename T>
cudaError_t in_bwd(const NormPlan& p, const NormBwdSrc<T>& src, T* dx,
                   float* out, float* scratch, unsigned int* tickets, int B,
                   cudaStream_t s) {
  cudaError_t e = launch_norm_sums(src, p, B, scratch, out, tickets, s);
  if (e != cudaSuccess) return e;
  return launch_norm_bwd_apply(src, p, scratch, dx, B, s);
}

}  // namespace smsut
