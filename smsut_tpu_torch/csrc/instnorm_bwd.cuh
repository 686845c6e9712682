// Instance-norm backward device code, NHWC: the device code of K4
// (instnorm_bwd.cu) and of the three norm backwards of K6 (block_bwd.cu).
//
// Per (sample, channel), over the n = H*W pixels, with d the cotangent
// after any activation mask and xhat = (x - mean) * rstd:
//   S_d = sum d,  S_dx = sum d * xhat,
//   dx = scale * rstd * (d - S_d/n - xhat * S_dx/n),
//   dscale = sum_b S_dx,  dbias = sum_b S_d.
//
// A 256x256 map does not fit one block, so the sums are taken as K1 takes
// its statistics: bwd_sums_kernel cuts H*W into nsplit slices of rows, each
// block writes one float32 partial per (sample, slice, sum, channel), and
// bwd_finalize_kernel adds the slices in a fixed order; batch_sum_kernel
// then adds the samples in a fixed order.  No atomics: runs agree bit for
// bit.  Each summand comes from a source functor Src (NS values per
// element), so K6 reuses the kernels for its pre-activation cotangent,
// whose mask and xhat differ.
#pragma once

#include "common.cuh"

namespace smsut {

// The H*W split of the sums pass (the rule of ops/instnorm.py `splits`).
inline void norm_splits(int hw, int c, int* nsplit, int* rows) {
  long long n = ((long long)hw * c + 16383) / 16384;
  if (n > 256) n = 256;
  if (n > hw) n = hw;
  if (n < 1) n = 1;
  *rows = (int)((hw + n - 1) / n);
  *nsplit = (hw + *rows - 1) / *rows;
}

// d and xhat of element e (channel c, sample b) of the instance norm
// y = xhat*scale + bias, act: d = g masked by y >= 0 (the mask of
// `_make_bwd_kernel`); the mask's y is computed with separate roundings.
template <typename T> struct NormBwdSrc {
  static constexpr int NS = 2;
  const T* x;
  const T* g;
  const float* mean;   // [B][C]
  const float* rstd;   // [B][C]
  const float* scale;  // [C]
  const float* bias;   // [C]
  int HW, C, act;

  __device__ __forceinline__ void d_xh(float xv, float gv, int b, int c,
                                       float& d, float& xh) const {
    const int bc = b * C + c;
    xh = __fmul_rn(__fsub_rn(xv, mean[bc]), rstd[bc]);
    d = gv;
    if (act && !(mul_add_rn(xh, scale[c], bias[c]) >= 0.f)) d = kSlope * gv;
  }
  __device__ __forceinline__ void operator()(int b, int r, int c,
                                             float v[NS]) const {
    const size_t e = ((size_t)b * HW + r) * C + c;
    float d, xh;
    d_xh(to_f(x[e]), to_f(g[e]), b, c, d, xh);
    v[0] = d;
    v[1] = d * xh;
  }
};

// grid (nsplit, B): block (s, b) sums Src's NS summands over rows
// [s*rows, (s+1)*rows) of sample b, for every channel; threads are laid out
// channel-fastest so that a warp reads contiguous memory.
// part [B][nsplit][NS][C].
template <class Src>
__global__ void __launch_bounds__(256)
bwd_sums_kernel(Src src, int HW, int C, int rows, float* __restrict__ part) {
  constexpr int NS = Src::NS;
  const int b = blockIdx.y, s = blockIdx.x, nsplit = gridDim.x;
  const int TX = C < 256 ? C : 256;
  const int TY = 256 / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int r0 = s * rows;
  const int r1 = min(HW, r0 + rows);
  __shared__ float red[NS][256];
  for (int cbase = 0; cbase < C; cbase += TX) {
    const int c = cbase + tx;
    float acc[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) acc[k] = 0.f;
    if (ty < TY && c < C) {
      for (int r = r0 + ty; r < r1; r += TY) {
        float v[NS];
        src(b, r, c, v);
#pragma unroll
        for (int k = 0; k < NS; ++k) acc[k] += v[k];
      }
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) red[k][threadIdx.x] = acc[k];
    __syncthreads();
    if (threadIdx.x < TX && c < C) {
      float* p = part + ((size_t)(b * nsplit + s) * NS) * C;
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        float a = 0.f;
        for (int q = 0; q < TY; ++q) a += red[k][q * TX + tx];
        p[(size_t)k * C + c] = a;
      }
    }
    __syncthreads();
  }
}

// sums[B][NS][C] = part summed over the nsplit slices, in order
template <int NS>
__global__ void bwd_finalize_kernel(const float* __restrict__ part,
                                    int nsplit, int C,
                                    float* __restrict__ sums) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    float s = 0.f;
    for (int t = 0; t < nsplit; ++t)
      s += part[((size_t)(b * nsplit + t) * NS + k) * C + c];
    sums[((size_t)b * NS + k) * C + c] = s;
  }
}

// out[k][c] = sum over b of sums[b][k][c], in order
__global__ void batch_sum_kernel(const float* __restrict__ sums, int B,
                                 int NS, int C, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NS * C) return;
  const int k = i / C, c = i % C;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += sums[((size_t)b * NS + k) * C + c];
  out[i] = s;
}

// sums pass, finalize and batch sums: sums [B][NS][C], out [NS][C]
template <class Src>
cudaError_t launch_bwd_sums(const Src& src, float* part, float* sums,
                            float* out, int B, int HW, int C,
                            cudaStream_t s) {
  constexpr int NS = Src::NS;
  int nsplit, rows;
  norm_splits(HW, C, &nsplit, &rows);
  bwd_sums_kernel<Src><<<dim3(nsplit, B), 256, 0, s>>>(src, HW, C, rows,
                                                       part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_finalize_kernel<NS><<<dim3((C + 127) / 128, B), 128, 0, s>>>(
      part, nsplit, C, sums);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  batch_sum_kernel<<<(NS * C + 127) / 128, 128, 0, s>>>(sums, B, NS, C, out);
  return cudaGetLastError();
}

// dx = scale*rstd*(d - S_d/n - xhat*S_dx/n), 4 channels per thread.
template <typename T>
__global__ void __launch_bounds__(256)
norm_bwd_apply_kernel(NormBwdSrc<T> src, const float* __restrict__ sums,
                      T* __restrict__ dx, long long n4) {
  const int C = src.C;
  const long long HWC = (long long)src.HW * C;
  const float n = (float)src.HW;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * 4;
    const int b = (int)(e / HWC);
    const int c = (int)(e % C);
    float xv[4], gv[4], out[4];
    load4(src.x + e, xv);
    load4(src.g + e, gv);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float d, xh;
      src.d_xh(xv[k], gv[k], b, c + k, d, xh);
      const float sd = sums[((size_t)b * 2) * C + c + k];
      const float sdx = sums[((size_t)b * 2 + 1) * C + c + k];
      const float a = src.scale[c + k] * src.rstd[b * C + c + k];
      out[k] = a * (d - sd / n - xh * (sdx / n));
    }
    store4(dx + e, out);
  }
}

template <typename T>
cudaError_t launch_norm_bwd_apply(const NormBwdSrc<T>& src, const float* sums,
                                  T* dx, int B, cudaStream_t s) {
  const long long n4 = (long long)B * src.HW * src.C / 4;
  norm_bwd_apply_kernel<T><<<elementwise_blocks(n4), 256, 0, s>>>(src, sums,
                                                                  dx, n4);
  return cudaGetLastError();
}

}  // namespace smsut
