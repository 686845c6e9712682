// Direct NHWC SAME convolution, stride 1, odd square kernel KS in {1, 3},
// float32 accumulation, on the CUDA cores: the float32 parity path of K2
// (conv3x3.cu, forward and the dx of the backward), of the convolutions of
// K3 (block.cu) and of the transposed convolutions of K6 (block_bwd.cu).
// Their bfloat16 paths run on the tensor cores (conv3x3_tc.cuh, with the
// same options as below).
//
//   y[b,i,j,co] = sum_{u,v,ci} x[b, i+u-KS/2, j+v-KS/2, ci] * w[u,v,ci,co]
//
// with zero padding; w is HWIO [KS][KS][Cin][Cout] (Cout contiguous), the
// layout the port stores its conv weights in.
//
// One block of 256 threads computes a TH x TW tile of output pixels times a
// TCO slice of output channels (TCO = 8, 16, 32 or 64; TH*TW*TCO = 4096).
// Each thread holds a 4-pixel x 4-channel register tile.  The loop runs
// over Cin in chunks of KC = 16: the (TH+KS-1) x (TW+KS-1) x KC halo tile
// of the input (stage_halo, shared with K5's conv_dw.cuh) and the
// KS*KS x KC x TCO weight slice are staged in shared memory as float32,
// then every tap and channel of the chunk is one float4 weight read, four
// input reads and 16 FMAs per thread.  The input tile's pixel stride is
// KC+1 floats, so the 4-pixel groups of a warp fall on distinct banks.
//
// Options of the template:
//   OutT:  the output's type (T, or float for K6's shortcut term);
//   STATS: the epilogue also sums y and y^2 over the tile's pixels per
//          channel, from the float32 accumulators, and writes them as the
//          tile's partial [B][ntiles][2][Cout] (no atomics; the finalize
//          kernel adds the tiles in a fixed order);
//   PRO:   the input is the previous conv's raw output, and the staging
//          step applies that norm's (g, h) and the leaky ReLU on the fly,
//          rounding to T as a stored activation would be, so the
//          normalised activation never reaches device memory.  The zero
//          padding stays zero: it pads the normalised map;
//   EPI:   kEpiAdd adds a float32 map [B][H][W][Cout] to the accumulators
//          before the one rounding to OutT (K6's dx: conv1^T(dy1) plus the
//          identity or shortcut term); kEpiMask multiplies them by
//          lrelu'(z), z = norm_act(y, g, h) rebuilt from a stored conv
//          output y [B][H][W][Cout] of type T and its norm's (g, h) (K6's
//          dz1 masked by z1);
//   WIN:   a row window (K3's and K6's chains split over a space group):
//          x holds hin rows and output row i takes its tap u from input
//          row i + u - KS/2 + off, rows outside [0, hin) being padding
//          (zero, left zero by PRO); H is the output's rows.  Off, the
//          window is SAME (hin = H, off = 0) and folds away at compile
//          time.
#pragma once

#include "common.cuh"

namespace smsut {

constexpr int kConvKC = 16;
constexpr int kConvKCP = kConvKC + 1;

template <int TCO> struct ConvTile {
  static constexpr int TW = TCO == 64 ? 8 : 16;
  static constexpr int TH = 4096 / TCO / TW;  // 8x8, 8x16, 16x16, 32x16
};

inline int conv_tco(int cout) {
  return cout % 64 == 0 ? 64 : cout % 32 == 0 ? 32 : cout % 16 == 0 ? 16 : 8;
}

inline int conv_ntiles(int H, int W, int cout) {
  const int tco = conv_tco(cout);
  const int tw = tco == 64 ? 8 : 16;
  const int th = 4096 / tco / tw;
  return ((H + th - 1) / th) * ((W + tw - 1) / tw);
}

// Stage the (TH+KS-1) x (TW+KS-1) pixel halo tile at (th0, tw0) of the
// sample xb [H][W][Cin], channels c0 .. c0+KC-1, into in_s as float32 with
// pixel stride KCP; zero outside the map and past Cin.  With PRO, each value
// v becomes norm_act<T>(v, gh[c], gh[Cin + c]).  Called by all 256 threads.
template <typename T, int KS, int TH, int TW, bool PRO>
__device__ __forceinline__ void stage_halo(float* __restrict__ in_s,
                                           const T* __restrict__ xb,
                                           const float* __restrict__ gh,
                                           int th0, int tw0, int c0, int H,
                                           int W, int Cin) {
  constexpr int KC = kConvKC, KCP = kConvKCP;
  constexpr int R = KS / 2;
  constexpr int IH = TH + 2 * R, IW = TW + 2 * R;
  for (int i = threadIdx.x; i < IH * IW * KC; i += 256) {
    const int ci = i % KC, pix = i / KC;
    const int gh_ = th0 + pix / IW - R, gw = tw0 + pix % IW - R;
    const int gc = c0 + ci;
    float v = 0.f;
    if (gh_ >= 0 && gh_ < H && gw >= 0 && gw < W && gc < Cin) {
      v = to_f(xb[((size_t)gh_ * W + gw) * Cin + gc]);
      if (PRO) v = norm_act<T>(v, gh[gc], gh[Cin + gc]);
    }
    in_s[pix * KCP + ci] = v;
  }
}

template <typename T, typename OutT, int KS, int TCO, bool STATS, bool PRO,
          int EPI, bool WIN = false>
__global__ void __launch_bounds__(256)
conv_tile_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 OutT* __restrict__ y, const float* __restrict__ pro_gh,
                 float* __restrict__ part, const void* __restrict__ epi,
                 const float* __restrict__ epi_gh, int H, int W, int Cin,
                 int Cout, int win_hin, int win_off) {
  constexpr int KC = kConvKC, KCP = kConvKCP;
  constexpr int TH = ConvTile<TCO>::TH, TW = ConvTile<TCO>::TW;
  constexpr int R = KS / 2;
  constexpr int IH = TH + 2 * R, IW = TW + 2 * R;
  constexpr int CG = TCO / 4;   // channel groups of 4
  constexpr int PG = 256 / CG;  // pixel groups of 4
  static_assert(PG * 4 == TH * TW, "tile");
  static_assert(TW % 4 == 0, "a pixel group lies in one row");
  constexpr int IN_SZ = (IH * IW * KCP + 3) / 4 * 4;
  constexpr int W_SZ = KS * KS * KC * TCO;
  static_assert(IN_SZ + W_SZ >= 2 * PG * TCO, "reduction buffer");
  __shared__ __align__(16) float smem[IN_SZ + W_SZ];
  float* in_s = smem;
  float* w_s = smem + IN_SZ;

  const int tid = threadIdx.x;
  const int cg = tid % CG, pg = tid / CG;
  const int tiles_w = (W + TW - 1) / TW;
  const int tile = blockIdx.x;
  const int th0 = (tile / tiles_w) * TH, tw0 = (tile % tiles_w) * TW;
  const int co0 = blockIdx.y * TCO;
  const int b = blockIdx.z;
  const int oh = (pg * 4) / TW, ow = (pg * 4) % TW;

  float acc[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;

  // x's rows, and the offset of the input row that output row 0 meets at
  // tap R
  const int hin = WIN ? win_hin : H, roff = WIN ? win_off : 0;
  const T* xb = x + (size_t)b * hin * W * Cin;
  const float* gh = PRO ? pro_gh + (size_t)b * 2 * Cin : nullptr;

  for (int c0 = 0; c0 < Cin; c0 += KC) {
    stage_halo<T, KS, TH, TW, PRO>(in_s, xb, gh, th0 + roff, tw0, c0, hin, W,
                                   Cin);
    for (int i = tid; i < KS * KS * KC * TCO; i += 256) {
      const int co = i % TCO, r = i / TCO;
      const int ci = r % KC, tap = r / KC;
      const int gc = c0 + ci;
      w_s[i] = (gc < Cin && co0 + co < Cout)
                   ? to_f(w[((size_t)tap * Cin + gc) * Cout + co0 + co])
                   : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < KS; ++u) {
#pragma unroll
      for (int v = 0; v < KS; ++v) {
        const float* wt = w_s + (u * KS + v) * KC * TCO + cg * 4;
        const float* it = in_s + ((oh + u) * IW + ow + v) * KCP;
#pragma unroll 4
        for (int ci = 0; ci < KC; ++ci) {
          const float4 wv = *reinterpret_cast<const float4*>(wt + ci * TCO);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float a = it[k * KCP + ci];
            acc[k][0] += a * wv.x;
            acc[k][1] += a * wv.y;
            acc[k][2] += a * wv.z;
            acc[k][3] += a * wv.w;
          }
        }
      }
    }
    __syncthreads();
  }

  const int gh0 = th0 + oh;
  const int co = co0 + cg * 4;
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int gw = tw0 + ow + k;
    if (gh0 < H && gw < W && co < Cout) {
      const size_t off = (((size_t)b * H + gh0) * W + gw) * Cout + co;
      if (EPI == kEpiAdd) {
        float a[4];
        load4(static_cast<const float*>(epi) + off, a);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[k][j] += a[j];
      }
      if (EPI == kEpiMask) {
        float yv[4];
        load4(static_cast<const T*>(epi) + off, yv);
        const float* g = epi_gh + (size_t)b * 2 * Cout;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[k][j] *= lrelu_grad(
              norm_act<T>(yv[j], g[co + j], g[Cout + co + j]));
      }
      store4(y + off, acc[k]);
      if (STATS) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s1[j] += acc[k][j];
          s2[j] += acc[k][j] * acc[k][j];
        }
      }
    }
  }
  if (STATS) {
    // the staging buffers are free after the loop's last __syncthreads
    float* red = smem;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[pg * TCO + cg * 4 + j] = s1[j];
      red[PG * TCO + pg * TCO + cg * 4 + j] = s2[j];
    }
    __syncthreads();
    if (tid < 2 * TCO) {
      const int which = tid / TCO, c = tid % TCO;
      float s = 0.f;
      for (int p = 0; p < PG; ++p) s += red[which * PG * TCO + p * TCO + c];
      if (co0 + c < Cout)
        part[(((size_t)b * gridDim.x + tile) * 2 + which) * Cout + co0 + c] = s;
    }
  }
}

// Launch with the widest channel tile that divides Cout (Cout % 8 == 0);
// H is y's rows, and with WIN x holds hin rows at the row offset off.
template <typename T, typename OutT, int KS, bool STATS, bool PRO, int EPI,
          bool WIN = false>
cudaError_t launch_conv_ex(const T* x, const T* w, OutT* y,
                           const float* pro_gh, float* part, const void* epi,
                           const float* epi_gh, int B, int H, int W, int Cin,
                           int Cout, cudaStream_t s, int hin = 0,
                           int off = 0) {
  if (WIN && hin < 1) return cudaErrorInvalidValue;
  const int tco = conv_tco(Cout);
  dim3 grid(conv_ntiles(H, W, Cout), Cout / tco, B);
#define SMSUT_CONV_LAUNCH(TCO)                                                \
  conv_tile_kernel<T, OutT, KS, TCO, STATS, PRO, EPI, WIN>                   \
      <<<grid, 256, 0, s>>>(x, w, y, pro_gh, part, epi, epi_gh, H, W, Cin,   \
                            Cout, hin, off)
  if (tco == 64)
    SMSUT_CONV_LAUNCH(64);
  else if (tco == 32)
    SMSUT_CONV_LAUNCH(32);
  else if (tco == 16)
    SMSUT_CONV_LAUNCH(16);
  else
    SMSUT_CONV_LAUNCH(8);
#undef SMSUT_CONV_LAUNCH
  return cudaGetLastError();
}

template <typename T, int KS, bool STATS, bool PRO>
cudaError_t launch_conv(const T* x, const T* w, T* y, const float* pro_gh,
                        float* part, int B, int H, int W, int Cin, int Cout,
                        cudaStream_t s) {
  return launch_conv_ex<T, T, KS, STATS, PRO, kEpiNone>(
      x, w, y, pro_gh, part, nullptr, nullptr, B, H, W, Cin, Cout, s);
}

}  // namespace smsut
