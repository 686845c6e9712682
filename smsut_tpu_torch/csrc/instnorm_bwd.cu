// K4: instance norm (+ leaky ReLU) backward, NHWC, float32 or bfloat16.
//
// Replaces the TPU kernel smsut_tpu/ops/instnorm_pallas.py `_bwd_call`
// (kernel `_make_bwd_kernel`): from x, the forward's mean and rstd, scale,
// bias and the cotangent g,
//   xhat = (x - mean)*rstd;  d = g, or g masked by y = xhat*scale + bias
//   >= 0 (slope 0.01 elsewhere) with the activation;
//   dx = scale*rstd*(d - mean(d) - xhat*mean(d*xhat))   in x's dtype;
//   dscale = sum over b, H*W of d*xhat;  dbias = sum of d   (float32).
//
// Bound on the H100: memory.  A few operations per element against two
// reads (x, g) and one write (dx); this version reads x and g twice.
//
// Design (instnorm_bwd.cuh): the TPU kernel holds one sample in VMEM and
// reduces it in one program; here the per-(sample, channel) sums go through
// per-slice float32 partials and a fixed-order finalize, as in K1, then a
// fixed-order sum over the batch gives dscale and dbias, and a grid-stride
// pass writes dx.  No atomics: runs agree bit for bit.
#include "instnorm_bwd.cuh"

using namespace smsut;

template <typename T>
static int run(const void* x, const void* g, const void* mean,
               const void* rstd, const void* scale, const void* bias,
               void* dx, void* dsb, void* part, void* sums, int B, int HW,
               int C, int act, cudaStream_t s) {
  NormBwdSrc<T> src{(const T*)x, (const T*)g, (const float*)mean,
                    (const float*)rstd, (const float*)scale,
                    (const float*)bias, HW, C, act};
  cudaError_t e = launch_bwd_sums(src, (float*)part, (float*)sums,
                                  (float*)dsb, B, HW, C, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_norm_bwd_apply(src, (const float*)sums, (T*)dx, B, s);
}

// float32 elements of the scratch smsut_instnorm_bwd needs
extern "C" long long smsut_instnorm_bwd_scratch(int B, int HW, int C) {
  int nsplit, rows;
  norm_splits(HW, C, &nsplit, &rows);
  return (long long)B * (nsplit + 1) * 2 * C;
}

// x, g, dx [B][HW][C] (C % 4 == 0), same dtype; mean, rstd [B][C] f32 (the
// forward's); scale, bias [C] f32; dsb [2][C] f32 = (dbias, dscale);
// scratch: smsut_instnorm_bwd_scratch floats.
extern "C" int smsut_instnorm_bwd(const void* x, const void* g,
                                  const void* mean, const void* rstd,
                                  const void* scale, const void* bias,
                                  void* dx, void* dsb, void* scratch, int B,
                                  int HW, int C, int dtype, int act,
                                  void* stream) {
  if (C % 4 != 0 || B < 1 || HW < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* sums = (float*)scratch;
  float* part = sums + (size_t)B * 2 * C;
  if (dtype == 0)
    return run<float>(x, g, mean, rstd, scale, bias, dx, dsb, part, sums, B,
                      HW, C, act, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, g, mean, rstd, scale, bias, dx, dsb, part,
                              sums, B, HW, C, act, s);
  return (int)cudaErrorInvalidValue;
}
