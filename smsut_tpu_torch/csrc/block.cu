// K3: fused residual BasicBlock forward, NHWC, float32 or bfloat16.
//
//   y1 = conv3x3(x, w1);  z1 = lrelu(IN(y1; s1, b1))
//   y2 = conv3x3(z1, w2); n2 = IN(y2; s2, b2)
//   idn = x                          (identity form, Cin == Cout)
//       | IN(conv1x1(x, ws); ss, bs)  (shortcut form, channel change)
//   out = lrelu(n2 + idn)
//
// Replaces the TPU kernel smsut_tpu/ops/block_pallas.py `_fwd_call`
// (kernel `_fwd_kernel`; public `fused_block`, `fused_block_short`,
// `fused_block_fwd`, `apply_fused_block`).  That kernel runs on the packed
// space-to-depth layout [B, H/2, W/2, 4C] (channel s*C + c) and pools its
// statistics over the 4 subpixel lane groups (`_group_affine`).  Here
// `groups` says which: 4 is that packed layout (Co = 4C; the finalize
// steps add each channel's tile partials, then its 4 groups in the order
// s = 0..3, over 4*H*W pixels, and write the group's (g, h), mean and rstd
// to every member; the norm parameters are [C]), 1 the unpacked NHWC map
// (the full-H*W statistics).  As there, the statistics come from the
// float32 conv accumulators, while the normalise steps read the stored
// (T-rounded) conv outputs.
//
// Bound on the H100: operations (the two 3x3 convs; see conv3x3.cu) at
// the deep levels, bytes (the maps) at 256^2 and 128^2.
//
// Design.  One TPU program holds a whole sample in VMEM; on the card the
// statistics of a 256x256 map span many blocks, so K3 is a chain of
// launches on one stream, each checked:
//   1. conv1 (STATS): y1, plus per-tile partial sums of y1;
//   2. finalize: (g1, h1) per (sample, channel);
//   3. conv2 (STATS, PRO): the input staging applies g1, h1 and the leaky
//      ReLU to y1 on the fly, so z1 never reaches device memory; writes y2
//      and its partial sums;
//   4. finalize: (g2, h2);
//   5. shortcut form only: the 1x1 conv (KS = 1, STATS) writes u and its
//      partial sums, then finalize: (gs, hs);
//   6. out: one elementwise pass, lrelu(y2*g2 + h2 + (u*gs + hs | x)).
// The convs run, by dtype alone, on the tensor cores in bfloat16
// (conv3x3_tc.cuh, the path of training and serving) and on the CUDA-core
// tile in float32 (conv_tile.cuh, the parity path), with the same options.
// A bfloat16 shape the tensor-core plan refuses returns
// cudaErrorInvalidValue before anything is launched: no fallback.  The
// partial count per sample comes from each conv's plan
// (smsut_block_ntiles), and finalize adds that many in a fixed order.
// In training the finalize steps also write each norm's mean and rstd, the
// statistics K6 (block_bwd.cu) takes with y1, y2, u and the (g, h) table.
// Against the unfused chain (K2, K1, K2, K1, 1x1 conv, K1, add, act) it
// keeps out of device memory: the write and read of z1, the statistics
// re-reads of y1, y2 and u, and the writes and reads of n2, of the
// normalised shortcut and of the pre-activation sum.  Under a space group
// (each rank holding rows of every image) the statistics are the image's:
// block_split.cu exposes each step of this chain, on the same device code
// (block.cuh), for the caller to add the sums over the group between them.
#include "block.cuh"

using namespace smsut;

template <typename T>
static int run(const T* x, const T* w1, const float* s1, const float* b1,
               const T* w2, const float* s2, const float* b2, const T* ws,
               const float* ss, const float* bs, T* out, T* y1, T* y2, T* u,
               float* part, float* gh, float* st, int B, int H, int W,
               int Ci, int Co, int G, cudaStream_t s) {
  // the tensor-core convs stage weights in 16-byte pieces
  constexpr bool tc = std::is_same<T, bf16>::value;
  int nt[3];
  if (!block_ntiles(B, H, W, Ci, Co, tc, nt) ||
      (tc && ((uintptr_t)w1 % 16 || (uintptr_t)w2 % 16 || (uintptr_t)ws % 16)))
    return (int)cudaErrorInvalidValue;
  const int HW = H * W;
  const size_t BC = (size_t)B * Co;
  float* gh1 = gh;
  float* gh2 = gh + 2 * BC;
  float* ghs = gh + 4 * BC;
  // (mean, rstd) of norm k at st + 2k*BC, st + (2k+1)*BC, when st is given
  auto mean = [&](int k) { return st ? st + 2 * k * BC : nullptr; };
  auto rstd = [&](int k) { return st ? st + (2 * k + 1) * BC : nullptr; };
  cudaError_t e;
  e = block_conv<0>(x, w1, y1, nullptr, part, B, H, W, Ci, Co, s);
  if (e != cudaSuccess) return (int)e;
  e = launch_finalize(part, nt[0], B, Co, HW, s1, b1, mean(0), rstd(0), gh1,
                      s, G);
  if (e != cudaSuccess) return (int)e;
  e = block_conv<1>(y1, w2, y2, gh1, part, B, H, W, Co, Co, s);
  if (e != cudaSuccess) return (int)e;
  e = launch_finalize(part, nt[1], B, Co, HW, s2, b2, mean(1), rstd(1), gh2,
                      s, G);
  if (e != cudaSuccess) return (int)e;
  if (ws) {
    e = block_conv<2>(x, ws, u, nullptr, part, B, H, W, Ci, Co, s);
    if (e != cudaSuccess) return (int)e;
    e = launch_finalize(part, nt[2], B, Co, HW, ss, bs, mean(2), rstd(2),
                        ghs, s, G);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n4 = (long long)B * HW * Co / 4;
  block_out_kernel<T><<<elementwise_blocks(n4), 256, 0, s>>>(
      y2, gh2, ws ? u : x, ws ? ghs : nullptr, out, n4, HW * Co, Co);
  return (int)cudaGetLastError();
}

// x [B][H][W][Ci]; w1 [3][3][Ci][Co], w2 [3][3][Co][Co], ws [Ci][Co] or
// null (identity form, Ci == Co), all in x's dtype; s*, b* [Co] f32.
// Scratch: y1, y2 [B][H][W][Co] and u (shortcut form) in x's dtype;
// part [B][ntiles][2][Co] f32 with ntiles = smsut_block_ntiles(B, H, W,
// Ci, Co, dtype); gh [3][B][2][Co] f32.  stats [3][2][B][Co] f32 (the
// (mean, rstd) of norms 1, 2 and s, the residuals K6 needs) or null
// (serving).  dtype 0 float32, 1 bfloat16.  groups 1 (the unpacked map) or
// 4 (the packed map: s*, b* are then [Co/4], and gh and stats hold each
// original channel's values at its 4 packed channels).
extern "C" int smsut_block_ntiles(int B, int H, int W, int Ci, int Co,
                                  int dtype) {
  int nt[3];
  if (!block_ntiles(B, H, W, Ci, Co, dtype, nt)) return 0;
  return nt[0] > nt[1] ? (nt[0] > nt[2] ? nt[0] : nt[2])
                       : (nt[1] > nt[2] ? nt[1] : nt[2]);
}

extern "C" int smsut_block_fwd(const void* x, const void* w1, const void* s1,
                               const void* b1, const void* w2, const void* s2,
                               const void* b2, const void* ws, const void* ss,
                               const void* bs, void* out, void* y1, void* y2,
                               void* u, void* part, void* gh, void* stats,
                               int B, int H, int W, int Ci, int Co,
                               int groups, int dtype, void* stream) {
  if (Co % 16 != 0 || (!ws && Ci != Co) || (groups != 1 && groups != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SMSUT_BLOCK_ARGS(T)                                                   \
  (const T*)x, (const T*)w1, (const float*)s1, (const float*)b1,            \
      (const T*)w2, (const float*)s2, (const float*)b2, (const T*)ws,       \
      (const float*)ss, (const float*)bs, (T*)out, (T*)y1, (T*)y2, (T*)u,   \
      (float*)part, (float*)gh, (float*)stats, B, H, W, Ci, Co, groups, s
  if (dtype == 0) return run<float>(SMSUT_BLOCK_ARGS(float));
  if (dtype == 1) return run<__nv_bfloat16>(SMSUT_BLOCK_ARGS(__nv_bfloat16));
#undef SMSUT_BLOCK_ARGS
  return (int)cudaErrorInvalidValue;
}
