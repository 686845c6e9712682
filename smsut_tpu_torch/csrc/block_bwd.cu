// K6: fused residual BasicBlock backward, NHWC, float32 or bfloat16.
//
// Replaces the TPU kernel smsut_tpu/ops/block_pallas.py `_bwd_call`
// (kernel `_bwd_kernel`), on the unpacked map (groups 1) or on the TPU
// kernel's own packed space-to-depth map (groups 4: channel s*C + c,
// Co = 4C), where each norm's sums pool the 4 subpixel groups of an
// original channel, in the order s = 0..3, over N = 4*H*W pixels, as the
// TPU kernel's group-norm backward does (`_bwd_kernel`, group_sum): after
// each sums pass (steps 1 and 5) one small pass adds the groups' per-sample
// sums and writes the total to every member (pool_group_sums_kernel).  The
// per-packed-channel dsb rows are added over the groups by the wrapper.  For the block of K3
//   y1 = conv3(x, w1); z1 = lrelu(n1(y1));  y2 = conv3(z1, w2);
//   pre = n2(y2) + (x | ns(conv1(x, ws)));  out = lrelu(pre)
// and the cotangent g of out, it returns dx (x's dtype), dw1, dw2, dws and
// the six norm-parameter gradients (float32).
//
// Residuals.  The TPU forward writes z1 and pre; K3 already stores y1, y2
// and u (its conv outputs, rounded to T) and the per-sample (g, h) of each
// norm, and in training also writes each norm's mean and rstd.  K6 rebuilds
// z1 = round_T(lrelu(y1*g1 + h1)) and pre = y2*g2 + h2 + (x | u*gs + hs)
// from them on the fly, with K3's roundings, so no extra map is written in
// the forward.  The statistics are the forward's, as the TPU backward's
// recompute from the same f32 dots gives.
//
// Rounding points and masks are the TPU kernel's:
//   gp = g * lrelu'(pre), lrelu'(v) = v > 0 ? 1 : slope (`_lrelu_mask`);
//   dy2 = a2*(round_T(gp) - S_gp/n - xh2*S_gp.xh2/n) -> T    (gb, :363)
//   du  = as*(gp - S_gp/n - xhs*S_gp.xhs/n)          -> T    (:476)
//   dn1 = round_T(conv2^T(dy2) * lrelu'(z1))                  (:378)
//   dy1 = a1*(dn1 - S_dn1/n - xh1*S_dn1.xh1/n)      -> T    (:421)
//   dx  = round(conv1^T(dy1) + (gp | du @ ws^T))    -> T    (:483)
// with xhK = (yK - meanK)*rstdK on the stored yK and aK = scaleK*rstdK.
//
// Bound on the H100: operations (four 3x3 convolutions' worth: dw2, dz1,
// dw1, dx, plus the shortcut's two 1x1 products).
//
// Design.  One TPU program holds a whole sample; here every per-sample
// group sum crosses blocks, so K6 is a chain of launches on one stream,
// each checked:
//   1. sums of gp, gp*xh2 (and gp*xhs): K4's sums pass, one launch whose
//      last blocks add the splits and the samples in a fixed order ->
//      dbias2, dscale2 (dscale_s; dbias_s is dbias2: both sum the same gp);
//   2. one elementwise pass: dy2, and du (shortcut form) or gp in float32
//      (identity form);
//   3. dw2 (K5's device code) with z1 rebuilt while staging (PRO);
//   4. dn1 = conv2^T(dy2) (K2's device code) with the z1 mask in its
//      epilogue;
//   5. sums of dn1, dn1*xh1 (K4's device code, instnorm_bwd.cuh) -> dbias1,
//      dscale1;  6. dy1 (K4's dx pass);  7. dw1 (K5's device code);
//   8. shortcut form: dws (K5's, KS = 1) and du @ ws^T in float32 (the
//      1x1 conv with a float32 output);
//   9. dx = conv1^T(dy1) plus that float32 term in the epilogue.
// The convs of steps 3, 4, 7, 8 and 9 run, by dtype alone, on the tensor
// cores in bfloat16 (conv3x3_tc.cuh, conv3x3_dw_tc.cuh: the path of
// training) and on the CUDA-core tiles in float32 (conv_tile.cuh,
// conv_dw.cuh: the parity path), with the same options.  A bfloat16 shape
// the tensor-core kernels refuse returns cudaErrorInvalidValue before
// anything is launched: no fallback.  No atomics: runs agree bit for bit.
// Under a space group the sums of steps 1 and 5 are the image's:
// block_bwd_split.cu exposes the steps, on the same device code
// (block_bwd.cuh), for the caller to add the sums over the group and take
// the cotangents' halos between them.
#include "block_bwd.cuh"

using namespace smsut;

static size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// Scratch layout (bytes), one arena allocated by the wrapper.  The weight
// gradients' partials follow each dtype's plan (conv_dw.cuh's dw_plan,
// conv3x3_dw_tc.cuh's dw_tc_plan), the norm sums' the two-pass plans of
// the two sums passes (instnorm_bwd.cuh); the sums of a pass come first.
struct Arena {
  size_t dy2, du, dn1, dy1, side, norm, dwpart, total;
  NormPlan po, p1;  // the sums of the block's output, of norm 1
  Arena(int B, int H, int W, int Ci, int Co, int shortcut, int dtype) {
    const size_t tsz = dtype == 0 ? 4 : 2;
    const size_t mapo = align256((size_t)B * H * W * Co * tsz);
    const int NS = shortcut ? 3 : 2;
    po = norm_two_pass_plan(B, H * W, Co, (int)tsz, 3, NS);
    p1 = norm_two_pass_plan(B, H * W, Co, (int)tsz, 2, 2);
    const long long no = norm_scratch_elems(po, B, Co, NS),
                    n1 = norm_scratch_elems(p1, B, Co, 2);
    const bool tc = dtype == 1;
    long long dwp = tc ? dw_tc_part_elems(B, H, W, Co, Co)
                       : dw_part_elems(B, H, W, Co, Co, 3);
    const long long dw1 = tc ? dw_tc_part_elems(B, H, W, Ci, Co)
                             : dw_part_elems(B, H, W, Ci, Co, 3);
    const long long dws = tc ? dw_tc_part_elems(B, H, W, Ci, Co, kDwTcTarget, 1)
                             : dw_part_elems(B, H, W, Ci, Co, 1);
    if (dw1 > dwp) dwp = dw1;
    if (shortcut && dws > dwp) dwp = dws;
    size_t o = 0;
    dy2 = o; o += mapo;
    du = o;  o += shortcut ? mapo : 0;
    dn1 = o; o += mapo;
    dy1 = o; o += mapo;
    side = o; o += align256((size_t)B * H * W * Ci * 4);
    norm = o; o += align256((size_t)(no > n1 ? no : n1) * 4);
    dwpart = o; o += align256((size_t)dwp * 4);
    total = o;
  }
};

// Whether the tensor-core kernels take every conv of the bfloat16 chain,
// checked before anything is launched (each would also refuse its own).
static bool tc_takes(int B, int H, int W, int Ci, int Co, int shortcut,
                     const void* w1t, const void* w2t, const void* wst) {
  return tc_fwd_tiles(B, H, W, Co, Co, 3) > 0 &&
         tc_fwd_tiles(B, H, W, Co, Ci, 3) > 0 && dw_tc_takes(Co, Co, 3) &&
         dw_tc_takes(Ci, Co, 3) &&
         (!shortcut ||
          (tc_fwd_tiles(B, H, W, Co, Ci, 1) > 0 && dw_tc_takes(Ci, Co, 1))) &&
         (uintptr_t)w1t % 16 == 0 && (uintptr_t)w2t % 16 == 0 &&
         (uintptr_t)wst % 16 == 0;
}

template <typename T, bool SHORT>
static int run(const T* g, const T* x, const T* y1, const T* y2, const T* u,
               const float* gh, const float* st, const T* w1t, const T* w2t,
               const T* wst, const float* s1, const float* s2,
               const float* ss, T* dx, float* dw1, float* dw2, float* dws,
               float* dsb, char* scratch, unsigned int* tickets,
               const Arena& A, int B, int H, int W, int Ci, int Co, int G,
               cudaStream_t s) {
  const int HW = H * W;
  const size_t BC = (size_t)B * Co;
  // stats [3][2][B][Co] = (mean, rstd) of norms 1, 2, s; gh [3][B][2][Co]
  const float* m1 = st;
  const float* r1 = st + BC;
  const float* m2 = st + 2 * BC;
  const float* r2 = st + 3 * BC;
  const float* ms = st + 4 * BC;
  const float* rs = st + 5 * BC;
  const float* gh1 = gh;
  const float* gh2 = gh + 2 * BC;
  const float* ghs = gh + 4 * BC;
  T* dy2 = (T*)(scratch + A.dy2);
  T* du = (T*)(scratch + A.du);
  T* dn1 = (T*)(scratch + A.dn1);
  T* dy1 = (T*)(scratch + A.dy1);
  float* side = (float*)(scratch + A.side);
  float* sums = (float*)(scratch + A.norm);  // [B][NS][Co], then partials
  float* dwpart = (float*)(scratch + A.dwpart);
  cudaError_t e;

  // 1-2. the pre-activation's cotangent: dsb rows 2, 3 (, 4)
  const BlockOutSrc<T, SHORT> src{g, y2, SHORT ? u : x, gh2, ghs,
                                  m2, r2, ms, rs, HW, Co};
  e = launch_norm_sums(src, A.po, B, sums, dsb + 2 * Co, tickets, s);
  if (e != cudaSuccess) return (int)e;
  e = pool_group_sums(sums, B * BlockOutSrc<T, SHORT>::NS, Co, G, s);
  if (e != cudaSuccess) return (int)e;
  const long long n4 = (long long)B * HW * Co / 4;
  block_dy2_kernel<T, SHORT><<<elementwise_blocks(n4), 256, 0, s>>>(
      src, sums, s2, ss, dy2, du, side, n4, (float)HW * (float)G);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // 3. dw2 = corr(z1, dy2), z1 rebuilt from y1 while staging
  e = bwd_dw<3, true>(y1, dy2, gh1, dwpart, dw2, B, H, W, Co, Co, s);
  if (e != cudaSuccess) return (int)e;
  // 4. dn1 = conv2^T(dy2) * lrelu'(z1)
  e = bwd_conv<3, T, kEpiMask>(dy2, w2t, dn1, y1, gh1, B, H, W, Co, Co, s);
  if (e != cudaSuccess) return (int)e;
  // 5-6. norm 1's backward: dsb rows 0, 1 and dy1
  const NormBwdSrc<T> n1{y1, dn1, m1, r1, s1, nullptr, HW, Co, 0};
  e = launch_norm_sums(n1, A.p1, B, sums, dsb, tickets, s);
  if (e != cudaSuccess) return (int)e;
  e = pool_group_sums(sums, B * 2, Co, G, s);
  if (e != cudaSuccess) return (int)e;
  e = launch_norm_bwd_apply(n1, A.p1, sums, dy1, B, s, (float)HW * (float)G);
  if (e != cudaSuccess) return (int)e;
  // 7. dw1 = corr(x, dy1)
  e = bwd_dw<3, false>(x, dy1, nullptr, dwpart, dw1, B, H, W, Ci, Co, s);
  if (e != cudaSuccess) return (int)e;
  // 8. the shortcut: dws = corr(x, du), side = du @ ws^T in float32
  if (SHORT) {
    e = bwd_dw<1, false>(x, du, nullptr, dwpart, dws, B, H, W, Ci, Co, s);
    if (e != cudaSuccess) return (int)e;
    e = bwd_conv<1, float, kEpiNone>(du, wst, side, nullptr, nullptr, B, H, W,
                                     Co, Ci, s);
    if (e != cudaSuccess) return (int)e;
  }
  // 9. dx = conv1^T(dy1) + side
  return (int)bwd_conv<3, T, kEpiAdd>(dy1, w1t, dx, side, nullptr, B, H, W,
                                      Co, Ci, s);
}

// bytes of the scratch smsut_block_bwd needs
extern "C" long long smsut_block_bwd_scratch(int B, int H, int W, int Ci,
                                             int Co, int shortcut,
                                             int dtype) {
  return (long long)Arena(B, H, W, Ci, Co, shortcut, dtype).total;
}

// g [B][H][W][Co] (the cotangent of out), x [B][H][W][Ci], y1, y2, u
// [B][H][W][Co] (K3's stored conv outputs; u null in the identity form),
// all of one dtype; gh [3][B][2][Co] and stats [3][2][B][Co] float32 (K3's
// per-sample (g, h) and (mean, rstd) of norms 1, 2, s); w1t [3][3][Co][Ci],
// w2t [3][3][Co][Co], wst [Co][Ci] (null in the identity form): the
// kernels flipped in space and IO-transposed, in x's dtype; s1, s2, ss [Co]
// f32.  Out: dx [B][H][W][Ci] in x's dtype; dw1 [3][3][Ci][Co], dw2
// [3][3][Co][Co], dws [Ci][Co] float32; dsb [5][Co] float32 = (dbias1,
// dscale1, dbias2, dscale2, dscale_s), dbias_s == dbias2; tickets: the
// norm sums' kNormTicketWords words, zero, kept for the stream
// (instnorm.cuh).  Ci % 8 == 0, Co % 16 == 0.  groups 1 (the unpacked
// map) or 4 (the packed map; s1, s2, ss then hold each original channel's
// scale at its 4 packed channels, and dsb's rows are per packed channel).
extern "C" int smsut_block_bwd(const void* g, const void* x, const void* y1,
                               const void* y2, const void* u, const void* gh,
                               const void* stats, const void* w1t,
                               const void* w2t, const void* wst,
                               const void* s1, const void* s2,
                               const void* ss, void* dx, void* dw1,
                               void* dw2, void* dws, void* dsb,
                               void* scratch, void* tickets, int B, int H,
                               int W, int Ci, int Co, int groups,
                               int dtype, void* stream) {
  const int shortcut = wst != nullptr;
  if (Co % 16 != 0 || Ci % 8 != 0 || (!shortcut && Ci != Co) ||
      (groups != 1 && groups != 4) ||
      (shortcut && !u) || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && !tc_takes(B, H, W, Ci, Co, shortcut, w1t, w2t, wst)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Arena A(B, H, W, Ci, Co, shortcut, dtype);
#define SMSUT_BWD_ARGS(T)                                                     \
  (const T*)g, (const T*)x, (const T*)y1, (const T*)y2, (const T*)u,        \
      (const float*)gh, (const float*)stats, (const T*)w1t, (const T*)w2t,  \
      (const T*)wst, (const float*)s1, (const float*)s2, (const float*)ss,  \
      (T*)dx, (float*)dw1, (float*)dw2, (float*)dws, (float*)dsb,           \
      (char*)scratch, (unsigned int*)tickets, A, B, H, W, Ci, Co, groups, s
  if (dtype == 0)
    return shortcut ? run<float, true>(SMSUT_BWD_ARGS(float))
                    : run<float, false>(SMSUT_BWD_ARGS(float));
  return shortcut ? run<__nv_bfloat16, true>(SMSUT_BWD_ARGS(__nv_bfloat16))
                  : run<__nv_bfloat16, false>(SMSUT_BWD_ARGS(__nv_bfloat16));
#undef SMSUT_BWD_ARGS
}
