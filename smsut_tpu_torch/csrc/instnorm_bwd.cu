// K4: instance norm (+ leaky ReLU) backward, NHWC, float32 or bfloat16, any
// number of channels.
//
// Replaces the TPU kernel smsut_tpu/ops/instnorm_pallas.py `_bwd_call`
// (kernel `_make_bwd_kernel`): from x, the forward's mean and rstd, scale,
// bias and the cotangent g,
//   xhat = (x - mean)*rstd;  d = g, or g masked by y = xhat*scale + bias
//   >= 0 (slope 0.01 elsewhere) with the activation;
//   dx = scale*rstd*(d - mean(d) - xhat*mean(d*xhat))   in x's dtype;
//   dscale = sum over b, H*W of d*xhat;  dbias = sum of d   (float32).
//
// Bound on the H100: memory.  A few operations per element against the
// least traffic of two reads (x, g) and one write (dx).
//
// Design (instnorm_bwd.cuh, on K1's two-pass plan): the TPU kernel holds
// one sample in VMEM and reduces it in one program.  Here two launches: the
// sums pass, whose last blocks add the splits and then the samples in a
// fixed order (elected by integer tickets), and the dx pass, whose read of
// x and g mostly hits the L2.  No float atomics: runs agree bit for bit.
#include "instnorm_bwd.cuh"

using namespace smsut;

// K4's plan for a shape, into out[kNormPlanWords] = (resident, vec, ng, G,
// U, nsplit, rows, smem); returns the float32 elements of scratch it needs,
// -1 for a shape or dtype it does not take.
extern "C" long long smsut_instnorm_bwd_plan(int B, int HW, int C, int dtype,
                                             int* out) {
  if (B < 1 || HW < 1 || C < 1 || (dtype != 0 && dtype != 1)) return -1;
  const NormPlan p = dtype == 0 ? in_bwd_plan<float>(B, HW, C)
                                : in_bwd_plan<__nv_bfloat16>(B, HW, C);
  norm_plan_words(p, out);
  return norm_scratch_elems(p, B, C, 2);
}

// x, g, dx [B][HW][C], same dtype; mean, rstd [B][C] f32 (the forward's);
// scale, bias [C] f32; dsb [2][C] f32 = (dbias, dscale); plan: the words
// smsut_instnorm_bwd_plan gave for this shape and dtype; scratch: the
// floats it asked for; tickets: kNormTicketWords words, zero, kept for the
// stream.
extern "C" int smsut_instnorm_bwd(const void* x, const void* g,
                                  const void* mean, const void* rstd,
                                  const void* scale, const void* bias,
                                  void* dx, void* dsb, const int* plan,
                                  void* scratch, void* tickets, int B,
                                  int HW, int C, int dtype, int act,
                                  void* stream) {
  if (B < 1 || HW < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SMSUT_IN_BWD(T)                                                      \
  in_bwd<T>(norm_plan_of(plan),                                              \
            NormBwdSrc<T>{(const T*)x, (const T*)g, (const float*)mean,      \
                          (const float*)rstd, (const float*)scale,           \
                          (const float*)bias, HW, C, act},                   \
            (T*)dx, (float*)dsb, (float*)scratch, (unsigned int*)tickets, B, \
            s)
  if (dtype == 0) return (int)SMSUT_IN_BWD(float);
  if (dtype == 1) return (int)SMSUT_IN_BWD(__nv_bfloat16);
#undef SMSUT_IN_BWD
  return (int)cudaErrorInvalidValue;
}

// ---- K4 split over a space group ----
//
// Where each rank of a space group holds rows of every image, dx needs the
// sums of d and d*xhat over the whole image: the rank's sums over its HW
// pixels (and their batch sums, the rank's share of dbias and dscale),
// added over the group by the caller, then the dx pass with the image's N
// pixels.  Both take smsut_instnorm_bwd_plan's plan.

// sums [B][2][C] f32 = (S_d, S_dxhat) over the rank's pixels; dsb [2][C] =
// their sums over the batch (dbias, dscale); scratch: at least the floats
// smsut_instnorm_bwd_plan asked for; the rest as for smsut_instnorm_bwd.
extern "C" int smsut_instnorm_bwd_sums(const void* x, const void* g,
                                       const void* mean, const void* rstd,
                                       const void* scale, const void* bias,
                                       void* sums, void* dsb, const int* plan,
                                       void* scratch, void* tickets, int B,
                                       int HW, int C, int dtype, int act,
                                       void* stream) {
  if (B < 1 || HW < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SMSUT_IN_BWD_SUMS(T)                                                 \
  launch_norm_sums_to(                                                       \
      NormBwdSrc<T>{(const T*)x, (const T*)g, (const float*)mean,            \
                    (const float*)rstd, (const float*)scale,                 \
                    (const float*)bias, HW, C, act},                         \
      norm_plan_of(plan), B, (float*)sums, (float*)scratch, (float*)dsb,     \
      (unsigned int*)tickets, s)
  if (dtype == 0) return (int)SMSUT_IN_BWD_SUMS(float);
  if (dtype == 1) return (int)SMSUT_IN_BWD_SUMS(__nv_bfloat16);
#undef SMSUT_IN_BWD_SUMS
  return (int)cudaErrorInvalidValue;
}

// dx as smsut_instnorm_bwd gives it, from sums [B][2][C] over N pixels (the
// image's, across the group).
extern "C" int smsut_instnorm_bwd_apply(const void* x, const void* g,
                                        const void* mean, const void* rstd,
                                        const void* scale, const void* bias,
                                        void* dx, const int* plan,
                                        const void* sums, int B, int HW,
                                        int N, int C, int dtype, int act,
                                        void* stream) {
  if (B < 1 || HW < 1 || C < 1 || N < HW) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SMSUT_IN_BWD_APPLY(T)                                                \
  launch_norm_bwd_apply(                                                     \
      NormBwdSrc<T>{(const T*)x, (const T*)g, (const float*)mean,            \
                    (const float*)rstd, (const float*)scale,                 \
                    (const float*)bias, HW, C, act},                         \
      norm_plan_of(plan), (const float*)sums, (T*)dx, B, s, (float)N)
  if (dtype == 0) return (int)SMSUT_IN_BWD_APPLY(float);
  if (dtype == 1) return (int)SMSUT_IN_BWD_APPLY(__nv_bfloat16);
#undef SMSUT_IN_BWD_APPLY
  return (int)cudaErrorInvalidValue;
}
