// Device helpers shared by the port's kernels (K1 instnorm.cu, K2
// conv3x3.cu, K3 block.cu, K4 instnorm_bwd.cu, K5 conv3x3_dw.cu, K6
// block_bwd.cu): dtype conversion, 4-wide loads and stores, the leaky ReLU
// and its mask, and the instance-norm finalize step that turns per-block
// partial sums into statistics.
//
// Activations are NHWC, float32 or bfloat16; everything the kernels
// accumulate is float32.  Instance-norm statistics follow the JAX reference
// exactly: mean = S1/n, var = S2/n - mean^2 (E[x^2] - mean^2, not a two-pass
// variance), rstd = 1/sqrt(var + 1e-5).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace smsut {

constexpr float kEps = 1e-5f;
constexpr float kSlope = 0.01f;
// a conv epilogue: none, add a float32 map, or multiply by a leaky-ReLU
// mask (conv_tile.cuh and conv3x3_tc.cuh say how)
enum { kEpiNone = 0, kEpiAdd = 1, kEpiMask = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch rounds
}

// the value a tensor of type T stores for v
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : kSlope * v; }

// lrelu'(v) as the TPU block backward takes it (`_lrelu_mask`): 1 where
// v > 0, else the slope (v == 0 included).
__device__ __forceinline__ float lrelu_grad(float v) { return v > 0.f ? 1.f : kSlope; }

// v*g + h with the product and the sum rounded separately, as PyTorch's
// elementwise ops round them.  Where a backward masks on the sign of such a
// value, an FMA here and none in the plain version would flip the mask of
// the elements that sit within one rounding of 0.
__device__ __forceinline__ float mul_add_rn(float v, float g, float h) {
  return __fadd_rn(__fmul_rn(v, g), h);
}

// a normalised, activated value as the forward stores it:
// round_T(lrelu(v*g + h))
template <typename T> __device__ __forceinline__ float norm_act(float v, float g, float h) {
  return round_to<T>(lrelu(mul_add_rn(v, g, h)));
}

// 4 consecutive elements; p is 16-byte (float) or 8-byte (bf16) aligned
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  uint2 q = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&q.x);
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&q.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<uint32_t*>(&a);
  q.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

// Partial sums part[B][nt][2][C] (sum, sum of squares over one slice of
// H*W each) -> per (b, c), summed over the nt slices in a fixed order, so
// that repeated runs agree bit for bit:
//   mean_out/rstd_out [B][C]   when mean_out is not null;
//   gh_out [B][2][C] = (g, h) with norm(x)*scale + bias == x*g + h,
//   g = scale*rstd, h = bias - mean*g, when gh_out is not null.
__global__ void finalize_kernel(const float* __restrict__ part, int nt, int C,
                                float n, const float* __restrict__ scale,
                                const float* __restrict__ bias,
                                float* __restrict__ mean_out,
                                float* __restrict__ rstd_out,
                                float* __restrict__ gh_out) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float* p = part + (size_t)b * nt * 2 * C;
  float s1 = 0.f, s2 = 0.f;
  for (int t = 0; t < nt; ++t) {
    s1 += p[(size_t)(2 * t) * C + c];
    s2 += p[(size_t)(2 * t + 1) * C + c];
  }
  const float mean = s1 / n;
  const float var = s2 / n - mean * mean;
  const float rstd = 1.f / sqrtf(var + kEps);
  if (mean_out) {
    mean_out[(size_t)b * C + c] = mean;
    rstd_out[(size_t)b * C + c] = rstd;
  }
  if (gh_out) {
    const float g = scale[c] * rstd;
    gh_out[(size_t)(2 * b) * C + c] = g;
    gh_out[(size_t)(2 * b + 1) * C + c] = bias[c] - mean * g;
  }
}

// finalize_kernel on the space-to-depth packed layout (G subpixel groups,
// channel s*(C/G) + c): the statistics of original channel c pool its G
// groups.  Each group's slices are added as above, then the groups in the
// order s = 0 .. G-1 (the TPU kernel's `_group_affine`), over n*G pixels;
// every member gets the group's mean, rstd and (g, h); scale and bias are
// [C/G].
__global__ void finalize_groups_kernel(const float* __restrict__ part,
                                       int nt, int C, float n, int G,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ bias,
                                       float* __restrict__ mean_out,
                                       float* __restrict__ rstd_out,
                                       float* __restrict__ gh_out) {
  const int b = blockIdx.y;
  const int Cg = C / G;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Cg) return;
  const float* p = part + (size_t)b * nt * 2 * C;
  float s1 = 0.f, s2 = 0.f;
  for (int q = 0; q < G; ++q) {
    float t1 = 0.f, t2 = 0.f;
    for (int t = 0; t < nt; ++t) {
      t1 += p[(size_t)(2 * t) * C + q * Cg + c];
      t2 += p[(size_t)(2 * t + 1) * C + q * Cg + c];
    }
    s1 = q ? s1 + t1 : t1;
    s2 = q ? s2 + t2 : t2;
  }
  const float N = n * (float)G;
  const float mean = s1 / N;
  const float var = s2 / N - mean * mean;
  const float rstd = 1.f / sqrtf(var + kEps);
  const float g = gh_out ? scale[c] * rstd : 0.f;
  for (int q = 0; q < G; ++q) {
    const size_t cq = (size_t)q * Cg + c;
    if (mean_out) {
      mean_out[(size_t)b * C + cq] = mean;
      rstd_out[(size_t)b * C + cq] = rstd;
    }
    if (gh_out) {
      gh_out[(size_t)(2 * b) * C + cq] = g;
      gh_out[(size_t)(2 * b + 1) * C + cq] = bias[c] - mean * g;
    }
  }
}

// G 1: the unpacked map (finalize_kernel); G 4: the packed map
// (finalize_groups_kernel)
inline cudaError_t launch_finalize(const float* part, int nt, int B, int C,
                                   int n, const float* scale,
                                   const float* bias, float* mean_out,
                                   float* rstd_out, float* gh_out,
                                   cudaStream_t s, int G = 1) {
  if (G == 1) {
    dim3 grid((C + 127) / 128, B);
    finalize_kernel<<<grid, 128, 0, s>>>(part, nt, C, (float)n, scale, bias,
                                         mean_out, rstd_out, gh_out);
  } else {
    dim3 grid((C / G + 127) / 128, B);
    finalize_groups_kernel<<<grid, 128, 0, s>>>(part, nt, C, (float)n, G,
                                                scale, bias, mean_out,
                                                rstd_out, gh_out);
  }
  return cudaGetLastError();
}

// grid size of a grid-stride elementwise pass over n4 groups of 4
inline int elementwise_blocks(long long n4) {
  long long blocks = (n4 + 255) / 256;
  return (int)(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
}

}  // namespace smsut
