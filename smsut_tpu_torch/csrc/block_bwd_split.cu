// K6 split at its norm sums, for a space rank's rows of every image
// (Config.spatial_parallel, parallel/mesh.py): the phases of block_bwd.cu's
// chain as entry points of their own, so that the caller (ops/block.py
// split_block_bwd) adds the sums over the space group between them and
// takes the cotangents' halos.  In the order the caller runs them:
//
//   bwd_out_sums:   the sums of gp, gp*xh2 (, gp*xhs) per (sample, channel)
//                   over the rank's rows, and their batch sums, the rank's
//                   (dbias2, dscale2, dscale_s);   (the group adds the sums)
//   bwd_dy2:        dy2, and du or gp, with the group's sums over the
//                   image's pixels;                (the caller takes dy2's halo)
//   bwd_conv k 0:   dn1 = conv2^T(dy2) * lrelu'(z1) on the rank's rows, from
//                   dy2 with its halo rows;
//   bwd_dw k 0:     dw2 = corr(z1, dy2), z1 rebuilt from y1 with the
//                   neighbours' rows that exist (PRO);
//   bwd_norm1_sums: the sums of dn1, dn1*xh1 and their batch sums, the
//                   rank's (dbias1, dscale1);       (the group adds the sums)
//   bwd_dy1:        dy1 from the group's sums;     (the caller takes dy1's halo)
//   bwd_dw k 1:     dw1 = corr(x, dy1), x with its halo rows;
//   bwd_dw k 2, bwd_conv k 1: the shortcut's dws and du @ ws^T;
//   bwd_conv k 2:   dx = conv1^T(dy1) + (gp | du @ ws^T) on the rank's rows.
//
// Where this can go wrong, and what the design does about it:
// - cotangents that cross ranks: dn1 convolves dy2, and dx dy1, over rows
//   the neighbours hold.  The caller takes their halos (zero beyond the
//   image, which is right for a cotangent: no output lies there), and the
//   convs read them through the row window; the adjoint of x's halo is not
//   needed, since dx is computed on the rank's own rows;
// - PRO turns a zero row into lrelu(h1): dw2's y1 holds only the
//   neighbours' rows that exist, as in block_split.cu's conv2;
// - who sums what: dx takes the group's sums (ops/instnorm.py's
//   convention); dscale, dbias (dsb) and dw1, dw2, dws are the rank's own
//   partials, which the group's gradient reduction adds once.  A dsb built
//   from sums already added over the group would be counted sp times.
// The sums passes are K4's device code (instnorm_bwd.cuh) and write the
// batch sums themselves; no atomics, runs agree bit for bit.
#include "block_bwd.cuh"

using namespace smsut;

static NormPlan out_plan(int B, int HW, int Co, int shortcut, int dtype) {
  return norm_two_pass_plan(B, HW, Co, dtype == 0 ? 4 : 2, 3,
                            shortcut ? 3 : 2);
}
static NormPlan norm1_plan(int B, int HW, int Co, int dtype) {
  return norm_two_pass_plan(B, HW, Co, dtype == 0 ? 4 : 2, 2, 2);
}

static long long dw_part(int B, int H, int W, int C, int Co, int ks,
                         int dtype) {
  return dtype == 1 ? dw_tc_part_elems(B, H, W, C, Co, kDwTcTarget, ks)
                    : dw_part_elems(B, H, W, C, Co, ks);
}

// float32 elements of the scratch every phase below takes at H rows (the
// largest of the sums passes' partials and the weight gradients' splits)
extern "C" long long smsut_block_bwd_split_scratch(int B, int H, int W,
                                                   int Ci, int Co,
                                                   int shortcut, int dtype) {
  const int NS = shortcut ? 3 : 2;
  long long n = norm_scratch_elems(out_plan(B, H * W, Co, shortcut, dtype),
                                   B, Co, NS);
  const long long cand[] = {
      norm_scratch_elems(norm1_plan(B, H * W, Co, dtype), B, Co, 2),
      dw_part(B, H, W, Co, Co, 3, dtype), dw_part(B, H, W, Ci, Co, 3, dtype),
      shortcut ? dw_part(B, H, W, Ci, Co, 1, dtype) : 0};
  for (long long c : cand) n = c > n ? c : n;
  return n;
}

template <typename T, bool SHORT>
static BlockOutSrc<T, SHORT> out_src(const void* g, const void* y2,
                                     const void* idn, const void* gh,
                                     const void* st, int B, int HW, int Co) {
  const size_t BC = (size_t)B * Co;
  const float* G = (const float*)gh;
  const float* S = (const float*)st;
  return BlockOutSrc<T, SHORT>{(const T*)g, (const T*)y2, (const T*)idn,
                               G + 2 * BC, G + 4 * BC, S + 2 * BC, S + 3 * BC,
                               S + 4 * BC, S + 5 * BC, HW, Co};
}

// g, y2 [B][H][W][Co] and idn (x in the identity form, u in the shortcut
// form), one dtype; gh [3][B][2][Co], st [3][2][B][Co] f32: K3's residuals.
// sums [B][NS][Co] and dsb [NS][Co] f32, NS = 2 (identity) or 3; scratch:
// smsut_block_bwd_split_scratch floats; tickets as in smsut_block_bwd.
extern "C" int smsut_block_bwd_out_sums(const void* g, const void* y2,
                                        const void* idn, const void* gh,
                                        const void* st, void* sums,
                                        void* dsb, void* scratch,
                                        void* tickets, int B, int H, int W,
                                        int Co, int shortcut, int dtype,
                                        void* stream) {
  if (B < 1 || H < 1 || W < 1 || Co % 16 != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const NormPlan p = out_plan(B, H * W, Co, shortcut, dtype);
#define SMSUT_OUT_SUMS(T, SH)                                                 \
  launch_norm_sums_to(out_src<T, SH>(g, y2, idn, gh, st, B, H * W, Co), p,   \
                      B, (float*)sums, (float*)scratch, (float*)dsb,        \
                      (unsigned int*)tickets, s)
  if (dtype == 0)
    return (int)(shortcut ? SMSUT_OUT_SUMS(float, true)
                          : SMSUT_OUT_SUMS(float, false));
  return (int)(shortcut ? SMSUT_OUT_SUMS(__nv_bfloat16, true)
                        : SMSUT_OUT_SUMS(__nv_bfloat16, false));
#undef SMSUT_OUT_SUMS
}

// dy2 [B][H][W][Co] (T) and dq: du (T, shortcut form) or gp (float32,
// identity form), from the group's sums [B][NS][Co] over N pixels; s2, ss
// [Co] f32.
extern "C" int smsut_block_bwd_dy2(const void* g, const void* y2,
                                   const void* idn, const void* gh,
                                   const void* st, const void* s2,
                                   const void* ss, const void* sums,
                                   void* dy2, void* dq, int B, int H, int W,
                                   int Co, int N, int shortcut, int dtype,
                                   void* stream) {
  if (B < 1 || H < 1 || W < 1 || Co % 16 != 0 || N < H * W ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n4 = (long long)B * H * W * Co / 4;
#define SMSUT_DY2(T, SH)                                                      \
  block_dy2_kernel<T, SH><<<elementwise_blocks(n4), 256, 0, s>>>(            \
      out_src<T, SH>(g, y2, idn, gh, st, B, H * W, Co), (const float*)sums, \
      (const float*)s2, (const float*)ss, (T*)dy2, SH ? (T*)dq : nullptr,   \
      SH ? nullptr : (float*)dq, n4, (float)N)
  if (dtype == 0) {
    if (shortcut)
      SMSUT_DY2(float, true);
    else
      SMSUT_DY2(float, false);
  } else {
    if (shortcut)
      SMSUT_DY2(__nv_bfloat16, true);
    else
      SMSUT_DY2(__nv_bfloat16, false);
  }
#undef SMSUT_DY2
  return (int)cudaGetLastError();
}

template <typename T>
static int bwd_conv_k(int k, const T* x, const T* w, void* y,
                      const void* epi, const float* epi_gh, int B, int Hin,
                      int Hout, int off, int W, int C, int Cout,
                      cudaStream_t s) {
  if (k == 0)
    return (int)bwd_conv<3, T, kEpiMask, true>(x, w, (T*)y, epi, epi_gh, B,
                                               Hout, W, C, Cout, s, Hin, off);
  if (k == 1)
    return Hin != Hout || off != 0
               ? (int)cudaErrorInvalidValue
               : (int)bwd_conv<1, float, kEpiNone>(x, w, (float*)y, nullptr,
                                                   nullptr, B, Hout, W, C,
                                                   Cout, s);
  return (int)bwd_conv<3, T, kEpiAdd, true>(x, w, (T*)y, epi, nullptr, B,
                                            Hout, W, C, Cout, s, Hin, off);
}

// Conv k of the chain on the rank's Hout rows, x [B][Hin][W][C] read
// through the row window (input row i + u - 1 + off at tap u), w
// [KS][KS][C][Cout] the flipped, IO-transposed kernel:
//   k 0: y = dn1 (T) = conv(dy2 with its halo, w2t) * lrelu'(norm_act(epi,
//        epi_gh)), epi = y1 [B][Hout][W][Cout], epi_gh = norm 1's (g, h);
//   k 1: y (float32) = du @ ws^T, the 1x1 (Hin == Hout, off 0);
//   k 2: y = dx (T) = conv(dy1 with its halo, w1t) + epi, epi the float32
//        [B][Hout][W][Cout] side term (gp or du @ ws^T).
extern "C" int smsut_block_bwd_conv(int k, const void* x, const void* w,
                                    void* y, const void* epi,
                                    const void* epi_gh, int B, int Hin,
                                    int Hout, int off, int W, int C,
                                    int Cout, int dtype, void* stream) {
  if (k < 0 || k > 2 || B < 1 || Hin < 1 || Hout < 1 || Cout % 8 != 0 ||
      (k != 1 && !epi) || (k == 0 && !epi_gh) ||
      (dtype == 1 && (uintptr_t)w % 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return bwd_conv_k<float>(k, (const float*)x, (const float*)w, y, epi,
                             (const float*)epi_gh, B, Hin, Hout, off, W, C,
                             Cout, s);
  if (dtype == 1)
    return bwd_conv_k<bf16>(k, (const bf16*)x, (const bf16*)w, y, epi,
                            (const float*)epi_gh, B, Hin, Hout, off, W, C,
                            Cout, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int bwd_dw_k(int k, const T* x, const T* g, const float* pro_gh,
                    float* part, float* dw, int B, int Hin, int Hout,
                    int off, int W, int C, int Cout, cudaStream_t s) {
  if (k == 0)
    return (int)bwd_dw<3, true, true>(x, g, pro_gh, part, dw, B, Hout, W, C,
                                      Cout, s, Hin, off);
  if (k == 1)
    return (int)bwd_dw<3, false, true>(x, g, nullptr, part, dw, B, Hout, W,
                                       C, Cout, s, Hin, off);
  return Hin != Hout || off != 0
             ? (int)cudaErrorInvalidValue
             : (int)bwd_dw<1, false>(x, g, nullptr, part, dw, B, Hout, W, C,
                                     Cout, s);
}

// Weight gradient k of the chain over the rank's Hout rows of g
// [B][Hout][W][Cout], x [B][Hin][W][C] through the row window; dw
// [KS][KS][C][Cout] float32, the rank's partial:
//   k 0: dw2 = corr(z1, dy2), z1 = norm_act(y1 with the neighbours' rows
//        that exist, pro_gh = norm 1's (g, h));
//   k 1: dw1 = corr(x with its halo rows, dy1);
//   k 2: dws = corr(x, du), the 1x1 (Hin == Hout, off 0).
// part: smsut_block_bwd_split_scratch floats.
extern "C" int smsut_block_bwd_dw(int k, const void* x, const void* g,
                                  const void* pro_gh, void* part, void* dw,
                                  int B, int Hin, int Hout, int off, int W,
                                  int C, int Cout, int dtype, void* stream) {
  if (k < 0 || k > 2 || B < 1 || Hin < 1 || Hout < 1 || Cout % 16 != 0 ||
      (k == 0 && !pro_gh))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return bwd_dw_k<float>(k, (const float*)x, (const float*)g,
                           (const float*)pro_gh, (float*)part, (float*)dw, B,
                           Hin, Hout, off, W, C, Cout, s);
  if (dtype == 1)
    return bwd_dw_k<bf16>(k, (const bf16*)x, (const bf16*)g,
                          (const float*)pro_gh, (float*)part, (float*)dw, B,
                          Hin, Hout, off, W, C, Cout, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static NormBwdSrc<T> norm1_src(const void* y1, const void* dn1,
                               const void* st, const void* s1, int B, int HW,
                               int Co) {
  const float* S = (const float*)st;
  return NormBwdSrc<T>{(const T*)y1, (const T*)dn1, S, S + (size_t)B * Co,
                       (const float*)s1, nullptr, HW, Co, 0};
}

// Norm 1's sums over the rank's rows: sums [B][2][Co] = (S_dn1,
// S_dn1*xh1) and dsb [2][Co] = their batch sums (dbias1, dscale1), from y1,
// dn1 [B][H][W][Co] and st (K3's [3][2][B][Co], norm 1's rows first).
extern "C" int smsut_block_bwd_norm1_sums(const void* y1, const void* dn1,
                                          const void* st, const void* s1,
                                          void* sums, void* dsb,
                                          void* scratch, void* tickets,
                                          int B, int H, int W, int Co,
                                          int dtype, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Co < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const NormPlan p = norm1_plan(B, H * W, Co, dtype);
#define SMSUT_N1_SUMS(T)                                                      \
  launch_norm_sums_to(norm1_src<T>(y1, dn1, st, s1, B, H * W, Co), p, B,     \
                      (float*)sums, (float*)scratch, (float*)dsb,           \
                      (unsigned int*)tickets, s)
  return (int)(dtype == 0 ? SMSUT_N1_SUMS(float)
                          : SMSUT_N1_SUMS(__nv_bfloat16));
#undef SMSUT_N1_SUMS
}

// dy1 [B][H][W][Co] (T) from the group's sums [B][2][Co] over N pixels.
extern "C" int smsut_block_bwd_dy1(const void* y1, const void* dn1,
                                   const void* st, const void* s1,
                                   const void* sums, void* dy1, int B, int H,
                                   int W, int Co, int N, int dtype,
                                   void* stream) {
  if (B < 1 || H < 1 || W < 1 || Co < 1 || N < H * W ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const NormPlan p = norm1_plan(B, H * W, Co, dtype);
  if (dtype == 0)
    return (int)launch_norm_bwd_apply(
        norm1_src<float>(y1, dn1, st, s1, B, H * W, Co), p,
        (const float*)sums, (float*)dy1, B, s, (float)N);
  return (int)launch_norm_bwd_apply(
      norm1_src<__nv_bfloat16>(y1, dn1, st, s1, B, H * W, Co), p,
      (const float*)sums, (__nv_bfloat16*)dy1, B, s, (float)N);
}
