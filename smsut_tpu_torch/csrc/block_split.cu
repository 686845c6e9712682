// K3 split at its norm statistics, for a space rank's rows of every image
// (Config.spatial_parallel, parallel/mesh.py): the phases of block.cu's
// chain as entry points of their own, so that the caller (ops/block.py
// split_block_fwd) adds each norm's sums over the space group between them.
//
//   fwd_conv k 0: conv1 over the rank's rows of x with their halos, and
//                 the sums of y1 and y1^2 per (sample, channel) over the
//                 rank's rows;
//            k 2: the shortcut's 1x1 conv and its sums;
//   (the caller adds the sums over the group)
//   fwd_finalize: (g, h), mean and rstd of a norm from the group's sums
//                 over the image's pixels (finalize_kernel on one partial);
//   fwd_conv k 1: conv2 with norm 1 applied while staging (PRO) over y1's
//                 rows with the neighbours' rows that exist, and its sums;
//   fwd_out:      block.cu's out pass on the rank's rows.
//
// Where this can go wrong, and what the design does about it:
// - the statistics' partials must cover the rank's own rows alone.  The
//   convs therefore take a row window (conv3x3_tc.cuh, conv_tile.cuh WIN):
//   x holds Hin rows, the output Hout, and output row i reads input row
//   i + u - 1 + off at tap u.  The tiles, and so the partials, run over the
//   Hout output rows only; the halo rows are inputs, never outputs;
// - PRO turns a zero row into lrelu(h1), not 0.  A halo row of y1 beyond
//   the image (mesh.halo_rows pads zeros there) would then be staged as
//   lrelu(0*g1 + h1) where z1's padding is 0.  So conv2's input holds only
//   the neighbours' rows that exist (a one-sided halo at the image's top
//   and bottom ranks), and the window's off says where it starts: a row
//   outside [0, Hin) is padding, which PRO leaves 0;
// - rounding: as block.cu, statistics from the float32 accumulators
//   (summed per tile, then the tiles in order here, then the ranks by the
//   caller's all-reduce), normalisation on the stored rounded y.
// Without a space group none of this runs: ops/block.py launches
// block.cu's one chain.
#include "block.cuh"

using namespace smsut;

// sums [B][2][C] of the partials part [B][nt][2][C], the tiles in order
__global__ void __launch_bounds__(128)
tile_sums_kernel(const float* __restrict__ part, int nt, int C,
                 float* __restrict__ sums) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float* p = part + (size_t)b * nt * 2 * C;
  float s1 = 0.f, s2 = 0.f;
  for (int t = 0; t < nt; ++t) {
    s1 += p[(size_t)(2 * t) * C + c];
    s2 += p[(size_t)(2 * t + 1) * C + c];
  }
  sums[(size_t)(2 * b) * C + c] = s1;
  sums[(size_t)(2 * b + 1) * C + c] = s2;
}

// the partials per sample of conv k (input channels C) at Hout output rows
static int conv_ntiles_of(int k, int B, int Hout, int W, int C, int Co,
                          bool tc) {
  return tc ? tc_fwd_tiles(B, Hout, W, C, Co, k == 2 ? 1 : 3)
            : conv_ntiles(Hout, W, Co);
}

template <typename T>
static int fwd_conv(int k, const T* x, const T* w, const float* pro_gh, T* y,
                    float* part, float* sums, int B, int Hin, int Hout,
                    int off, int W, int C, int Co, cudaStream_t s) {
  constexpr bool tc = std::is_same<T, bf16>::value;
  const int nt = conv_ntiles_of(k, B, Hout, W, C, Co, tc);
  if (nt < 1 || (tc && (uintptr_t)w % 16) ||
      (k == 2 && (Hin != Hout || off != 0)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (k == 0)
    e = block_conv<0, true>(x, w, y, nullptr, part, B, Hout, W, C, Co, s,
                            Hin, off);
  else if (k == 1)
    e = block_conv<1, true>(x, w, y, pro_gh, part, B, Hout, W, C, Co, s, Hin,
                            off);
  else
    e = block_conv<2>(x, w, y, nullptr, part, B, Hout, W, C, Co, s);
  if (e != cudaSuccess) return (int)e;
  tile_sums_kernel<<<dim3((Co + 127) / 128, B), 128, 0, s>>>(part, nt, Co,
                                                             sums);
  return (int)cudaGetLastError();
}

// float32 elements of the partials smsut_block_fwd_conv needs for any of
// the chain's three convs at Hout rows (input channels Ci, then Co for
// conv2); 0 where the bfloat16 plan refuses one
extern "C" long long smsut_block_split_part(int B, int Hout, int W, int Ci,
                                            int Co, int dtype) {
  int nt[3];
  if (!block_ntiles(B, Hout, W, Ci, Co, dtype, nt)) return 0;
  int m = nt[0] > nt[1] ? nt[0] : nt[1];
  m = m > nt[2] ? m : nt[2];
  return (long long)B * m * 2 * Co;
}

// Conv k of the chain (0 conv1, 1 conv2 with pro_gh [B][2][C] = norm 1's
// (g, h) applied while staging, 2 the 1x1 shortcut), y [B][Hout][W][Co] =
// conv(x [B][Hin][W][C], w) with output row i reading input row
// i + u - 1 + off at tap u (the shortcut: Hin == Hout, off 0), and sums
// [B][2][Co] f32 = the sums of y and y^2 over its Hout rows from the
// float32 accumulators; part: smsut_block_split_part floats.  dtype 0
// float32, 1 bfloat16 (x, w, y).
extern "C" int smsut_block_fwd_conv(int k, const void* x, const void* w,
                                    const void* pro_gh, void* y, void* part,
                                    void* sums, int B, int Hin, int Hout,
                                    int off, int W, int C, int Co, int dtype,
                                    void* stream) {
  if (k < 0 || k > 2 || Co % 16 != 0 || B < 1 || Hin < 1 || Hout < 1 ||
      (k == 1 && !pro_gh))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SMSUT_FWD_CONV(T)                                                     \
  fwd_conv<T>(k, (const T*)x, (const T*)w, (const float*)pro_gh, (T*)y,     \
              (float*)part, (float*)sums, B, Hin, Hout, off, W, C, Co, s)
  if (dtype == 0) return SMSUT_FWD_CONV(float);
  if (dtype == 1) return SMSUT_FWD_CONV(__nv_bfloat16);
#undef SMSUT_FWD_CONV
  return (int)cudaErrorInvalidValue;
}

// One norm's (g, h) [B][2][Co] and, where mean is not null, mean and rstd
// [B][Co] from sums [B][2][Co] (the group's) over n pixels (the image's),
// as block.cu's finalize steps give them.
extern "C" int smsut_block_fwd_finalize(const void* sums, const void* scale,
                                        const void* bias, void* mean,
                                        void* rstd, void* gh, int B, int Co,
                                        int n, void* stream) {
  if (B < 1 || Co < 1 || n < 1 || (!mean) != (!rstd))
    return (int)cudaErrorInvalidValue;
  return (int)launch_finalize((const float*)sums, 1, B, Co, n,
                              (const float*)scale, (const float*)bias,
                              (float*)mean, (float*)rstd, (float*)gh,
                              (cudaStream_t)stream);
}

// out [B][H][W][Co] = lrelu(y2*g2 + h2 + (u*gs + hs | x)), block.cu's out
// pass: idn is x (ghs null, identity form) or u.
extern "C" int smsut_block_fwd_out(const void* y2, const void* gh2,
                                   const void* idn, const void* ghs,
                                   void* out, int B, int H, int W, int Co,
                                   int dtype, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Co % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n4 = (long long)B * H * W * Co / 4;
#define SMSUT_FWD_OUT(T)                                                      \
  block_out_kernel<T><<<elementwise_blocks(n4), 256, 0, s>>>(                \
      (const T*)y2, (const float*)gh2, (const T*)idn, (const float*)ghs,    \
      (T*)out, n4, H * W * Co, Co)
  if (dtype == 0)
    SMSUT_FWD_OUT(float);
  else if (dtype == 1)
    SMSUT_FWD_OUT(__nv_bfloat16);
  else
    return (int)cudaErrorInvalidValue;
#undef SMSUT_FWD_OUT
  return (int)cudaGetLastError();
}
