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
// space-to-depth layout and pools its statistics over the 4 subpixel lane
// groups (`_group_affine`); on the unpacked NHWC map those are simply the
// full-H*W statistics computed here.  As there, the statistics come from
// the float32 conv accumulators, while the normalise steps read the stored
// (T-rounded) conv outputs.
//
// Bound on the H100: operations (the two 3x3 convs; see conv3x3.cu).
//
// Design.  One TPU program holds a whole sample in VMEM; on the card the
// statistics of a 256x256 map span many blocks, so K3 is a chain of
// launches on one stream, each checked:
//   1. conv1 (conv_tile.cuh, STATS): y1, plus per-tile partial sums of y1;
//   2. finalize: (g1, h1) per (sample, channel);
//   3. conv2 (STATS, PRO): the input staging applies g1, h1 and the leaky
//      ReLU to y1 on the fly, so z1 never reaches device memory; writes y2
//      and its partial sums;
//   4. finalize: (g2, h2);
//   5. shortcut form only: the 1x1 conv (KS = 1, STATS) writes u and its
//      partial sums, then finalize: (gs, hs);
//   6. out: one elementwise pass, lrelu(y2*g2 + h2 + (u*gs + hs | x)).
// Against the unfused chain (K2, K1, K2, K1, 1x1 conv, K1, add, act) it
// keeps out of device memory: the write and read of z1, the statistics
// re-reads of y1, y2 and u, and the writes and reads of n2, of the
// normalised shortcut and of the pre-activation sum.
#include "conv_tile.cuh"

using namespace smsut;

template <typename T>
__global__ void __launch_bounds__(256)
block_out_kernel(const T* __restrict__ y2, const float* __restrict__ gh2,
                 const T* __restrict__ idn, const float* __restrict__ ghs,
                 T* __restrict__ out, long long n4, int HWC, int C) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * 4;
    const int b = (int)(e / HWC);
    const int c = (int)(e % C);
    const float* g2 = gh2 + (size_t)2 * b * C;
    float v[4], d[4];
    load4(y2 + e, v);
    load4(idn + e, d);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float t = v[k] * g2[c + k] + g2[C + c + k];
      if (ghs) {
        const float* gs = ghs + (size_t)2 * b * C;
        t += d[k] * gs[c + k] + gs[C + c + k];
      } else {
        t += d[k];
      }
      v[k] = lrelu(t);
    }
    store4(out + e, v);
  }
}

template <typename T>
static int run(const T* x, const T* w1, const float* s1, const float* b1,
               const T* w2, const float* s2, const float* b2, const T* ws,
               const float* ss, const float* bs, T* out, T* y1, T* y2, T* u,
               float* part, float* gh, int B, int H, int W, int Ci, int Co,
               cudaStream_t s) {
  const int nt = conv_ntiles(H, W, Co);
  const int HW = H * W;
  float* gh1 = gh;
  float* gh2 = gh + (size_t)2 * B * Co;
  float* ghs = gh + (size_t)4 * B * Co;
  cudaError_t e;
  e = launch_conv<T, 3, true, false>(x, w1, y1, nullptr, part, B, H, W, Ci,
                                     Co, s);
  if (e != cudaSuccess) return (int)e;
  e = launch_finalize(part, nt, B, Co, HW, s1, b1, nullptr, nullptr, gh1, s);
  if (e != cudaSuccess) return (int)e;
  e = launch_conv<T, 3, true, true>(y1, w2, y2, gh1, part, B, H, W, Co, Co,
                                    s);
  if (e != cudaSuccess) return (int)e;
  e = launch_finalize(part, nt, B, Co, HW, s2, b2, nullptr, nullptr, gh2, s);
  if (e != cudaSuccess) return (int)e;
  if (ws) {
    e = launch_conv<T, 1, true, false>(x, ws, u, nullptr, part, B, H, W, Ci,
                                       Co, s);
    if (e != cudaSuccess) return (int)e;
    e = launch_finalize(part, nt, B, Co, HW, ss, bs, nullptr, nullptr, ghs,
                        s);
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
// part [B][ntiles][2][Co] f32 with ntiles = smsut_block_ntiles(H, W, Co);
// gh [3][B][2][Co] f32.
extern "C" int smsut_block_ntiles(int H, int W, int Co) {
  return conv_ntiles(H, W, Co);
}

extern "C" int smsut_block_fwd(const void* x, const void* w1, const void* s1,
                               const void* b1, const void* w2, const void* s2,
                               const void* b2, const void* ws, const void* ss,
                               const void* bs, void* out, void* y1, void* y2,
                               void* u, void* part, void* gh, int B, int H,
                               int W, int Ci, int Co, int dtype,
                               void* stream) {
  if (Co % 16 != 0 || (!ws && Ci != Co)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SMSUT_BLOCK_ARGS(T)                                                   \
  (const T*)x, (const T*)w1, (const float*)s1, (const float*)b1,            \
      (const T*)w2, (const float*)s2, (const float*)b2, (const T*)ws,       \
      (const float*)ss, (const float*)bs, (T*)out, (T*)y1, (T*)y2, (T*)u,   \
      (float*)part, (float*)gh, B, H, W, Ci, Co, s
  if (dtype == 0) return run<float>(SMSUT_BLOCK_ARGS(float));
  if (dtype == 1) return run<__nv_bfloat16>(SMSUT_BLOCK_ARGS(__nv_bfloat16));
#undef SMSUT_BLOCK_ARGS
  return (int)cudaErrorInvalidValue;
}
