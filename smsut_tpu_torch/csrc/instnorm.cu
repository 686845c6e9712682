// K1: instance norm (+ leaky ReLU) forward, NHWC, float32 or bfloat16, any
// number of channels.
//
// Replaces the TPU kernel smsut_tpu/ops/instnorm_pallas.py `_fwd_call`
// (kernel `_make_fwd_kernel`; public `instance_norm_lrelu` /
// `instance_norm_affine`): per sample and channel, f32 statistics over H*W
// with var = E[x^2] - mean^2, eps 1e-5, then *scale + bias, then an
// optional LeakyReLU(0.01).  Also emits mean and rstd [B][C].
//
// Bound on the H100: memory.  It does a few operations per element, far
// below the card's ~295 operations per byte: the least it can move is one
// read of x and one write of y.
//
// Design (instnorm.cuh).  The TPU kernel keeps one sample's [H, W, C] map
// in VMEM and makes one read and one write of it.  Here a thread-block
// cluster keeps a sample's channel group in the shared memory of up to 16
// blocks, which exchange their partial sums over distributed shared memory:
// one launch, one read, one write (the resident plan).  Where the slices
// do not fit, the clusters do not fit the card in one wave (a 16-block
// cluster of 128 KB blocks fits 7 times on the H100, so bfloat16 at
// [8,256,256,16] is out), or the blocks would hold too little to pay for
// the cluster's synchronisation (16^2 x 256 in bfloat16), a sums pass and
// an apply pass (the two-pass plan): two launches, and the second read
// mostly hits the L2.  The plan is picked by shape (in_fwd_plan, printed by
// the wrapper's `plan`).  No float atomics: runs agree bit for bit.
#include "instnorm.cuh"

using namespace smsut;

// K1's plan for a shape on the current device, into out[kNormPlanWords] =
// (resident, vec, ng, G, U, nsplit, rows, smem); returns the float32
// elements of scratch it needs, -1 for a shape or dtype it does not take.
extern "C" long long smsut_instnorm_fwd_plan(int B, int HW, int C, int dtype,
                                             int* out) {
  if (B < 1 || HW < 1 || C < 1 || (dtype != 0 && dtype != 1)) return -1;
  const NormPlan p = dtype == 0 ? in_fwd_plan<float>(B, HW, C)
                                : in_fwd_plan<__nv_bfloat16>(B, HW, C);
  norm_plan_words(p, out);
  return p.resident ? 0 : norm_scratch_elems(p, B, C, 2);
}

// x, y [B][HW][C], same dtype; scale, bias [C] f32; mean, rstd [B][C] f32;
// plan: the words smsut_instnorm_fwd_plan gave for this shape, dtype and
// device; scratch: the floats it asked for; tickets: kNormTicketWords
// words, zero, kept for the stream.
extern "C" int smsut_instnorm_fwd(const void* x, const void* scale,
                                  const void* bias, void* y, void* mean,
                                  void* rstd, const int* plan, void* scratch,
                                  void* tickets, int B, int HW, int C,
                                  int dtype, int act, void* stream) {
  if (B < 1 || HW < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SMSUT_IN_FWD(T)                                                      \
  in_fwd<T>(norm_plan_of(plan), (const T*)x, (const float*)scale,            \
            (const float*)bias, (T*)y, (float*)mean, (float*)rstd,         \
            (float*)scratch, (unsigned int*)tickets, B, HW, C, act, s)
  if (dtype == 0) return (int)SMSUT_IN_FWD(float);
  if (dtype == 1) return (int)SMSUT_IN_FWD(__nv_bfloat16);
#undef SMSUT_IN_FWD
  return (int)cudaErrorInvalidValue;
}

// ---- K1 split over a space group ----
//
// Where each rank of a space group holds rows of every image, the
// statistics run over the whole image: the rank's sums (a sums pass over
// its HW pixels), added over the group by the caller, then the apply pass
// with the image's N pixels.  Both passes take the two-pass plan.

// The split form's plan for a rank's map, into out[kNormPlanWords]; returns
// the float32 elements of the partials the sums pass needs, -1 for a shape
// or dtype it does not take.
extern "C" long long smsut_instnorm_split_plan(int B, int HW, int C,
                                               int dtype, int* out) {
  if (B < 1 || HW < 1 || C < 1 || (dtype != 0 && dtype != 1)) return -1;
  const NormPlan p = dtype == 0 ? in_split_plan<float>(B, HW, C)
                                : in_split_plan<__nv_bfloat16>(B, HW, C);
  norm_plan_words(p, out);
  return (long long)B * p.nsplit * 2 * C;
}

// sums [B][2][C] f32: the sums of x and x^2 over the rank's HW pixels;
// part: the floats smsut_instnorm_split_plan asked for; tickets as for
// smsut_instnorm_fwd.
extern "C" int smsut_instnorm_fwd_sums(const void* x, const int* plan,
                                       void* sums, void* part, void* tickets,
                                       int B, int HW, int C, int dtype,
                                       void* stream) {
  if (B < 1 || HW < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const NormPlan p = norm_plan_of(plan);
  if (dtype == 0)
    return (int)in_fwd_sums(p, (const float*)x, (float*)sums, (float*)part,
                            (unsigned int*)tickets, B, HW, C, s);
  if (dtype == 1)
    return (int)in_fwd_sums(p, (const __nv_bfloat16*)x, (float*)sums,
                            (float*)part, (unsigned int*)tickets, B, HW, C, s);
  return (int)cudaErrorInvalidValue;
}

// y, mean, rstd as smsut_instnorm_fwd gives them, from sums [B][2][C] over
// N pixels (the image's, across the group).
extern "C" int smsut_instnorm_fwd_apply(const void* x, const void* scale,
                                        const void* bias, void* y, void* mean,
                                        void* rstd, const int* plan,
                                        const void* sums, int B, int HW,
                                        int N, int C, int dtype, int act,
                                        void* stream) {
  if (B < 1 || HW < 1 || C < 1 || N < HW) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SMSUT_IN_APPLY(T)                                                    \
  in_apply<T>(norm_plan_of(plan), (const T*)x, (const float*)scale,          \
              (const float*)bias, (T*)y, (float*)mean, (float*)rstd,         \
              (const float*)sums, B, HW, C, act, (float)N, s)
  if (dtype == 0) return (int)SMSUT_IN_APPLY(float);
  if (dtype == 1) return (int)SMSUT_IN_APPLY(__nv_bfloat16);
#undef SMSUT_IN_APPLY
  return (int)cudaErrorInvalidValue;
}
