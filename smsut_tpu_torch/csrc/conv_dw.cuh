// Weight gradient of the NHWC SAME convolution, KS in {1, 3}, on the CUDA
// cores: the float32 parity path of K5 (conv3x3_dw.cu) and of the three
// weight gradients of K6 (block_bwd.cu).  Their bfloat16 paths run on the
// tensor cores (conv3x3_dw_tc.cuh, with the same KS and PRO options).
//
//   dw[u][v][ci][co] = sum_{b,i,j} x[b, i+u-KS/2, j+v-KS/2, ci] * g[b,i,j,co]
//
// with zero padding, accumulated and returned in float32: the
// batch-accumulated correlation of the TPU kernel `_dw_kernel`.
//
// The reduction runs over B*H*W pixels (524,288 at the U-Net's level 0)
// into only KS*KS*Cin*Cout outputs, so it is split: a block owns one
// KC = 16 chunk of Cin, one TCO chunk of Cout and a contiguous run of the
// B * ntiles pixel tiles (the tiles of conv_tile.cuh, TH*TW*TCO = 4096).
// Per tile it stages the input halo (stage_halo, with K3's PRO option so
// that K6 can rebuild z1 from y1 on the fly) and the g tile in shared
// memory.  Thread (ci, channel group of 4, pixel subset) accumulates its
// KS*KS x 4 outputs in registers over the pixels of its subset; at the end
// the subsets are added in a fixed order in shared memory and the block
// writes one float32 partial per split.  A second kernel adds the splits in
// a fixed order.  No atomics anywhere, so runs agree bit for bit.
#pragma once

#include "conv_tile.cuh"

namespace smsut {

constexpr int kDwTargetBlocks = 4 * 132;  // about 4 blocks on each SM

template <typename T, int KS, int TCO, bool PRO>
__global__ void __launch_bounds__(256)
dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  const float* __restrict__ pro_gh, float* __restrict__ part,
                  int B, int H, int W, int Cin, int Cout,
                  int tiles_per_split) {
  constexpr int KC = kConvKC, KCP = kConvKCP;
  constexpr int TH = ConvTile<TCO>::TH, TW = ConvTile<TCO>::TW;
  constexpr int R = KS / 2;
  constexpr int IH = TH + 2 * R, IW = TW + 2 * R;
  constexpr int NT = KS * KS;
  constexpr int CG = TCO / 4;
  constexpr int NPS = 256 / (KC * CG);  // pixel subsets
  static_assert(NPS * KC * CG == 256, "thread layout");
  constexpr int IN_SZ = (IH * IW * KCP + 3) / 4 * 4;
  constexpr int G_SZ = TH * TW * TCO;
  constexpr int RED_SZ = NPS * NT * KC * TCO;
  constexpr int SMEM = IN_SZ + G_SZ > RED_SZ ? IN_SZ + G_SZ : RED_SZ;
  __shared__ __align__(16) float smem[SMEM];
  float* in_s = smem;
  float* g_s = smem + IN_SZ;

  const int tid = threadIdx.x;
  const int ci = tid % KC, cg = (tid / KC) % CG, ps = tid / (KC * CG);
  const int split = blockIdx.x;
  const int c0 = blockIdx.y * KC;
  const int co0 = blockIdx.z * TCO;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_img = tiles_w * ((H + TH - 1) / TH);
  const int t0 = split * tiles_per_split;
  const int t1 = min(B * tiles_img, t0 + tiles_per_split);

  float acc[NT][4];
#pragma unroll
  for (int k = 0; k < NT; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int b = t / tiles_img, tile = t % tiles_img;
    const int th0 = (tile / tiles_w) * TH, tw0 = (tile % tiles_w) * TW;
    stage_halo<T, KS, TH, TW, PRO>(
        in_s, x + (size_t)b * H * W * Cin,
        PRO ? pro_gh + (size_t)b * 2 * Cin : nullptr, th0, tw0, c0, H, W,
        Cin);
    for (int i = tid; i < TH * TW * CG; i += 256) {
      const int q = i % CG, p = i / CG;
      const int gh_ = th0 + p / TW, gw = tw0 + p % TW;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (gh_ < H && gw < W)
        load4(g + (((size_t)b * H + gh_) * W + gw) * Cout + co0 + q * 4, v);
      store4(g_s + p * TCO + q * 4, v);
    }
    __syncthreads();
    for (int p = ps; p < TH * TW; p += NPS) {
      const int oh = p / TW, ow = p % TW;
      const float4 gv = *reinterpret_cast<const float4*>(g_s + p * TCO + cg * 4);
#pragma unroll
      for (int u = 0; u < KS; ++u) {
#pragma unroll
        for (int v = 0; v < KS; ++v) {
          const float a = in_s[((oh + u) * IW + ow + v) * KCP + ci];
          acc[u * KS + v][0] += a * gv.x;
          acc[u * KS + v][1] += a * gv.y;
          acc[u * KS + v][2] += a * gv.z;
          acc[u * KS + v][3] += a * gv.w;
        }
      }
    }
    __syncthreads();
  }

  // add the NPS pixel subsets in a fixed order
  float* red = smem;
#pragma unroll
  for (int k = 0; k < NT; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[((ps * NT + k) * KC + ci) * TCO + cg * 4 + j] = acc[k][j];
  __syncthreads();
  for (int o = tid; o < NT * KC * TCO; o += 256) {
    float s = 0.f;
    for (int q = 0; q < NPS; ++q) s += red[q * NT * KC * TCO + o];
    const int co = o % TCO, r = o / TCO;
    const int cil = r % KC, tap = r / KC;
    if (c0 + cil < Cin)
      part[(((size_t)split * NT + tap) * Cin + c0 + cil) * Cout + co0 + co] = s;
  }
}

// dw[i] = sum over the nsplit partials part[s][i], in order
__global__ void __launch_bounds__(256)
dw_reduce_kernel(const float* __restrict__ part, int nsplit, int n,
                 float* __restrict__ dw) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < nsplit; ++t) s += part[(size_t)t * n + i];
    dw[i] = s;
  }
}

// The split of the pixel tiles: (nsplit, tiles per split), so that the
// grid has about kDwTargetBlocks blocks.  Cout % 16 == 0.
inline void dw_plan(int B, int H, int W, int Cin, int Cout, int* nsplit,
                    int* tps) {
  const int total = B * conv_ntiles(H, W, Cout);
  const int base = ((Cin + kConvKC - 1) / kConvKC) * (Cout / conv_tco(Cout));
  int want = (kDwTargetBlocks + base - 1) / base;
  want = want < 1 ? 1 : (want > total ? total : want);
  *tps = (total + want - 1) / want;
  *nsplit = (total + *tps - 1) / *tps;
}

// float32 elements of the partial buffer launch_dw needs
inline long long dw_part_elems(int B, int H, int W, int Cin, int Cout,
                               int KS) {
  int nsplit, tps;
  dw_plan(B, H, W, Cin, Cout, &nsplit, &tps);
  return (long long)nsplit * KS * KS * Cin * Cout;
}

template <typename T, int KS, bool PRO>
cudaError_t launch_dw(const T* x, const T* g, const float* pro_gh,
                      float* part, float* dw, int B, int H, int W, int Cin,
                      int Cout, cudaStream_t s) {
  int nsplit, tps;
  dw_plan(B, H, W, Cin, Cout, &nsplit, &tps);
  const int tco = conv_tco(Cout);
  dim3 grid(nsplit, (Cin + kConvKC - 1) / kConvKC, Cout / tco);
#define SMSUT_DW_LAUNCH(TCO)                                                  \
  dw_partial_kernel<T, KS, TCO, PRO><<<grid, 256, 0, s>>>(                   \
      x, g, pro_gh, part, B, H, W, Cin, Cout, tps)
  if (tco == 64)
    SMSUT_DW_LAUNCH(64);
  else if (tco == 32)
    SMSUT_DW_LAUNCH(32);
  else if (tco == 16)
    SMSUT_DW_LAUNCH(16);
  else
    return cudaErrorInvalidValue;
#undef SMSUT_DW_LAUNCH
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n = KS * KS * Cin * Cout;
  dw_reduce_kernel<<<elementwise_blocks(n), 256, 0, s>>>(part, nsplit, n, dw);
  return cudaGetLastError();
}

}  // namespace smsut
