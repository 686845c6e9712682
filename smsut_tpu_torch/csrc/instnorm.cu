// K1: instance norm (+ leaky ReLU) forward, NHWC, float32 or bfloat16.
//
// Replaces the TPU kernel smsut_tpu/ops/instnorm_pallas.py `_fwd_call`
// (kernel `_make_fwd_kernel`; public `instance_norm_lrelu` /
// `instance_norm_affine`): per sample and channel, f32 statistics over H*W
// with var = E[x^2] - mean^2, eps 1e-5, then *scale + bias, then an
// optional LeakyReLU(0.01).  Also emits mean and rstd [B][C].
//
// Bound on the H100: memory.  It does a few operations per element, far
// below the card's ~295 operations per byte, and moves two reads and one
// write of x (the statistics pass, then the normalise pass).
//
// Design.  The TPU kernel keeps one sample's [H, W, C] map in VMEM and
// reduces it in one program; a CUDA block cannot hold a 256x256 map, so
// the H*W reduction is split across blocks:
//   1. stats:    grid (nsplit, B); each block sums x and x^2 over one slice
//                of H*W rows for every channel, threads laid out channel-
//                fastest so a warp reads contiguous memory, and writes one
//                f32 partial (sum, sumsq) per (sample, slice, channel);
//   2. finalize: one thread per (sample, channel) adds the nsplit partials
//                in a fixed order (no atomics: runs agree bit for bit) and
//                writes mean and rstd;
//   3. apply:    a grid-stride channels-last pass, 4 elements (16 or 8
//                bytes) per thread: ((x - mean)*rstd)*scale + bias, act.
// The wrapper (ops/instnorm.py) picks nsplit so that the card gets a few
// hundred blocks, and checks the return code of every launch.
#include "common.cuh"

using namespace smsut;

template <typename T>
__global__ void __launch_bounds__(256)
in_stats_kernel(const T* __restrict__ x, int HW, int C, int rows,
                float* __restrict__ part) {
  const int b = blockIdx.y, s = blockIdx.x, nsplit = gridDim.x;
  const int TX = C < 256 ? C : 256;
  const int TY = 256 / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int r0 = s * rows;
  const int r1 = min(HW, r0 + rows);
  __shared__ float red[2][256];
  const T* xb = x + (size_t)b * HW * C;
  for (int cbase = 0; cbase < C; cbase += TX) {
    const int c = cbase + tx;
    float s1 = 0.f, s2 = 0.f;
    if (ty < TY && c < C) {
      for (int r = r0 + ty; r < r1; r += TY) {
        const float v = to_f(xb[(size_t)r * C + c]);
        s1 += v;
        s2 += v * v;
      }
    }
    red[0][threadIdx.x] = s1;
    red[1][threadIdx.x] = s2;
    __syncthreads();
    if (threadIdx.x < TX && c < C) {
      float a = 0.f, q = 0.f;
      for (int k = 0; k < TY; ++k) {
        a += red[0][k * TX + tx];
        q += red[1][k * TX + tx];
      }
      float* p = part + ((size_t)(b * nsplit + s) * 2) * C;
      p[c] = a;
      p[C + c] = q;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
in_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                const float* __restrict__ rstd, const float* __restrict__ scale,
                const float* __restrict__ bias, T* __restrict__ y,
                long long n4, int HWC, int C, int act) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * 4;
    const int b = (int)(e / HWC);
    const int c = (int)(e % C);
    float v[4];
    load4(x + e, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int bc = b * C + c + k;
      float t = (v[k] - mean[bc]) * rstd[bc];
      t = t * scale[c + k] + bias[c + k];
      v[k] = act ? lrelu(t) : t;
    }
    store4(y + e, v);
  }
}

template <typename T>
static int run(const void* x, const void* scale, const void* bias, void* y,
               void* mean, void* rstd, void* part, int B, int HW, int C,
               int nsplit, int rows, int act, cudaStream_t s) {
  in_stats_kernel<T><<<dim3(nsplit, B), 256, 0, s>>>(
      (const T*)x, HW, C, rows, (float*)part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = launch_finalize((const float*)part, nsplit, B, C, HW, nullptr, nullptr,
                      (float*)mean, (float*)rstd, nullptr, s);
  if (e != cudaSuccess) return (int)e;
  const long long n4 = (long long)B * HW * C / 4;
  in_apply_kernel<T><<<elementwise_blocks(n4), 256, 0, s>>>(
      (const T*)x, (const float*)mean, (const float*)rstd,
      (const float*)scale, (const float*)bias, (T*)y, n4, HW * C, C, act);
  return (int)cudaGetLastError();
}

// x, y [B][HW][C] (C % 4 == 0); scale, bias [C] f32; mean, rstd [B][C] f32;
// part [B][nsplit][2][C] f32 scratch; rows = H*W rows per split.
extern "C" int smsut_instnorm_fwd(const void* x, const void* scale,
                                  const void* bias, void* y, void* mean,
                                  void* rstd, void* part, int B, int HW, int C,
                                  int nsplit, int rows, int dtype, int act,
                                  void* stream) {
  if (C % 4 != 0 || nsplit < 1 || (long long)nsplit * rows < HW)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return run<float>(x, scale, bias, y, mean, rstd, part, B, HW, C, nsplit,
                      rows, act, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, scale, bias, y, mean, rstd, part, B, HW, C,
                              nsplit, rows, act, s);
  return (int)cudaErrorInvalidValue;
}
