// Direct NHWC SAME convolution, stride 1, odd square kernel KS in {1, 3},
// float32 accumulation: the device code of K2 (conv3x3.cu) and of the
// three convolutions of K3 (block.cu).
//
//   y[b,i,j,co] = sum_{u,v,ci} x[b, i+u-KS/2, j+v-KS/2, ci] * w[u,v,ci,co]
//
// with zero padding; w is HWIO [KS][KS][Cin][Cout] (Cout contiguous), the
// layout the port stores its conv weights in.
//
// One block of 256 threads computes a TH x TW tile of output pixels times a
// TCO slice of output channels (TCO = 16, 32 or 64; TH*TW*TCO = 4096).
// Each thread holds a 4-pixel x 4-channel register tile.  The loop runs
// over Cin in chunks of KC = 16: the (TH+KS-1) x (TW+KS-1) x KC halo tile
// of the input and the KS*KS x KC x TCO weight slice are staged in shared
// memory as float32, then every tap and channel of the chunk is one
// float4 weight read, four input reads and 16 FMAs per thread.  The input
// tile's pixel stride is KC+1 floats, so the 4-pixel groups of a warp fall
// on distinct banks.  No tensor cores yet: mma/wgmma and TMA are later work.
//
// Options of the template, used by K3:
//   STATS: the epilogue also sums y and y^2 over the tile's pixels per
//          channel, from the float32 accumulators, and writes them as the
//          tile's partial [B][ntiles][2][Cout] (no atomics; the finalize
//          kernel adds the tiles in a fixed order);
//   PRO:   the input is the previous conv's raw output, and the staging
//          step applies that norm's (g, h) and the leaky ReLU on the fly,
//          rounding to T as a stored activation would be, so the
//          normalised activation never reaches device memory.  The zero
//          padding stays zero: it pads the normalised map.
#pragma once

#include "common.cuh"

namespace smsut {

constexpr int kConvKC = 16;
constexpr int kConvKCP = kConvKC + 1;

template <int TCO> struct ConvTile {
  static constexpr int TW = TCO == 64 ? 8 : 16;
  static constexpr int TH = 4096 / TCO / TW;  // 16x16, 8x16, 8x8 pixels
};

inline int conv_tco(int cout) {
  return cout % 64 == 0 ? 64 : (cout % 32 == 0 ? 32 : 16);
}

inline int conv_ntiles(int H, int W, int cout) {
  const int tco = conv_tco(cout);
  const int tw = tco == 64 ? 8 : 16;
  const int th = 4096 / tco / tw;
  return ((H + th - 1) / th) * ((W + tw - 1) / tw);
}

template <typename T, int KS, int TCO, bool STATS, bool PRO>
__global__ void __launch_bounds__(256)
conv_tile_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ y, const float* __restrict__ pro_gh,
                 float* __restrict__ part, int H, int W, int Cin, int Cout) {
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

  const T* xb = x + (size_t)b * H * W * Cin;
  const float* gh = PRO ? pro_gh + (size_t)b * 2 * Cin : nullptr;

  for (int c0 = 0; c0 < Cin; c0 += KC) {
    for (int i = tid; i < IH * IW * KC; i += 256) {
      const int ci = i % KC, pix = i / KC;
      const int gh_ = th0 + pix / IW - R, gw = tw0 + pix % IW - R;
      const int gc = c0 + ci;
      float v = 0.f;
      if (gh_ >= 0 && gh_ < H && gw >= 0 && gw < W && gc < Cin) {
        v = to_f(xb[((size_t)gh_ * W + gw) * Cin + gc]);
        if (PRO) v = round_to<T>(lrelu(v * gh[gc] + gh[Cin + gc]));
      }
      in_s[pix * KCP + ci] = v;
    }
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
      store4(y + (((size_t)b * H + gh0) * W + gw) * Cout + co, acc[k]);
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

template <typename T, int KS, bool STATS, bool PRO>
cudaError_t launch_conv(const T* x, const T* w, T* y, const float* pro_gh,
                        float* part, int B, int H, int W, int Cin, int Cout,
                        cudaStream_t s) {
  const int tco = conv_tco(Cout);
  dim3 grid(conv_ntiles(H, W, Cout), Cout / tco, B);
  if (tco == 64)
    conv_tile_kernel<T, KS, 64, STATS, PRO><<<grid, 256, 0, s>>>(
        x, w, y, pro_gh, part, H, W, Cin, Cout);
  else if (tco == 32)
    conv_tile_kernel<T, KS, 32, STATS, PRO><<<grid, 256, 0, s>>>(
        x, w, y, pro_gh, part, H, W, Cin, Cout);
  else
    conv_tile_kernel<T, KS, 16, STATS, PRO><<<grid, 256, 0, s>>>(
        x, w, y, pro_gh, part, H, W, Cin, Cout);
  return cudaGetLastError();
}

}  // namespace smsut
