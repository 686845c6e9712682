// The weight gradient of the stride-1 SAME convolution on the tensor
// cores, NHWC bf16 x and g, float32 result: K5's bfloat16 path
// (conv3x3_dw.cu routes bfloat16 here; float32 stays on conv_dw.cuh) and
// the three weight gradients of K6's bfloat16 chain (block_bwd.cu).
//
//   dw[u][v][ci][co] = sum_{b,i,j} x[b, i+u-KS/2, j+v-KS/2, ci] * g[b,i,j,co]
//
// For each tap (u, v) this is a product of M = Cin, N = Cout and K = the
// B*H*W pixels: A = the tap's shifted x, transposed ([ci][pixel]), B = g
// ([pixel][co]).  Bound on the H100: 2*9*Cin*Cout operations per pixel
// against (Cin + Cout) * 2 bytes, as in the forward.
//
// Design:
// - the pixels are cut into tiles of 8 image rows x 16 columns; one tile
//   row is one k16 step.  A block owns MC (16 or 32) input and NC (16, 32
//   or 64) output channels and a contiguous run of the B * tiles pixel
//   tiles (a split); per tile it stages the (8+KS-1) x (16+KS-1) halo of x
//   (channels of
//   its MC, zero outside the image and past Cin, stage_halo_bf16) and the
//   8 x 16 tile of g (zero past H and W, so pixels off the map add 0) by
//   cp.async, the next tile's into a second buffer while this one's
//   products run;
// - a warp owns one unit, 16 input x 16 output channels, for all KS*KS
//   taps (9 x 2 m16n8 accumulators, 72 floats a thread, at KS 3): per tile
//   row one ldmatrix.x4.trans of g (the B fragments of its 16 channels)
//   feeds the taps, and per tap one ldmatrix.x4.trans of x at the row shifted
//   by (u, v) gives the transposed A fragment.  There are U =
//   (MC/16)(NC/16) units; where U < 8, 8/U warps share a unit and take
//   every (8/U)-th tile row, and add their sums in a fixed order in shared
//   memory at the end;
// - each split writes a float32 partial [KS*KS][Cin][Cout] and a second
//   kernel adds the splits in a fixed order (with one split the block
//   writes dw itself).  No atomics, so two runs agree bit for bit.  The
//   splits aim at two blocks per SM (dw_tc_plan).
// Options of the template, for K6: KS = 1 (dws, the shortcut's 1x1 conv:
// the halo is the tile, one tap); PRO, x is a stored conv output and each
// staged halo is normalised and activated in shared memory once its copies
// have landed (pro_halo_bf16: z1 = norm_act<bf16>(y1, g1, h1) for dw2),
// the padding staying 0.
// Not yet: wgmma, TMA or a reduction that overlaps the products.
#pragma once

#include "mma_tile.cuh"

namespace smsut {

constexpr int kDwTcThreads = 256;
constexpr int kDwTcWarps = kDwTcThreads / 32;
constexpr int kDwTcTH = 8;    // tile rows
constexpr int kDwTcTW = 16;   // tile columns: one k16 step per tile row
constexpr int kDwTcTarget = 2 * kSMs;  // blocks in the grid, about

inline int dw_tc_mc(int C) { return C > 16 ? 32 : 16; }
inline int dw_tc_nc(int Cout) {
  return Cout % 64 == 0 ? 64 : Cout % 32 == 0 ? 32 : 16;
}

// shared memory of one block: two stage buffers, or the [KS*KS][MC][NC]
// float32 sums of the warps that share a unit, whichever is larger
inline size_t dw_tc_smem(int MC, int NC, int ks = 3) {
  const size_t stage =
      ((kDwTcTH + ks - 1) * (kDwTcTW + ks - 1) * padded_row(MC) +
       kDwTcTH * kDwTcTW * padded_row(NC)) * sizeof(bf16);
  const bool shared_units = (MC / 16) * (NC / 16) < kDwTcWarps;
  const size_t red =
      shared_units ? (size_t)ks * ks * MC * NC * sizeof(float) : 0;
  return 2 * stage > red ? 2 * stage : red;
}

// Whether the kernel takes the channels (Cout % 16 == 0, a block within
// the device's shared memory): the checks of conv3x3_dw_tc but the
// pointer's and the map's.
inline bool dw_tc_takes(int C, int Cout, int ks) {
  return C >= 1 && Cout >= 16 && Cout % 16 == 0 &&
         dw_tc_smem(dw_tc_mc(C), dw_tc_nc(Cout), ks) <= smem_optin_bytes();
}

// The split of the pixel tiles: (nsplit, tiles per split), so that the
// grid has about `target` blocks.  At the deep levels (few pixels, many
// channels) the partials outweigh the inputs, but fewer splits cost more:
// on an H100 (700 W) one split of 16 tiles at [8,16,16,128] -> 256 took
// 0.052 ms, 16 splits of one tile and their reduce 0.027 ms.
inline void dw_tc_plan(int B, int H, int W, int C, int Cout, int* nsplit,
                       int* tps, int target = kDwTcTarget) {
  const int tiles = B * ((H + kDwTcTH - 1) / kDwTcTH) *
                    ((W + kDwTcTW - 1) / kDwTcTW);
  const int mc = dw_tc_mc(C);
  const int base = ((C + mc - 1) / mc) * (Cout / dw_tc_nc(Cout));
  int want = (target + base - 1) / base;
  want = want < 1 ? 1 : (want > tiles ? tiles : want);
  *tps = (tiles + want - 1) / want;
  *nsplit = (tiles + *tps - 1) / *tps;
}

// float32 elements of the partials conv3x3_dw_tc needs (0: one split)
inline long long dw_tc_part_elems(int B, int H, int W, int C, int Cout,
                                  int target = kDwTcTarget, int ks = 3) {
  int nsplit, tps;
  dw_tc_plan(B, H, W, C, Cout, &nsplit, &tps, target);
  return nsplit > 1 ? (long long)nsplit * ks * ks * C * Cout : 0;
}

// One block: split blockIdx.x (tiles t0 .. t1-1 of the B * tiles), input
// channels c0 .. c0+MC-1, output channels co0 .. co0+NC-1; writes
// out[split][KS*KS][C][Cout] at its channels.  Stage buffer s holds the
// halo x_s [(8+KS-1)*XW][XS] (halo pixel (r, c) at row r*XW + c, XW =
// 16+KS-1) and g_s [8*16][GS].
template <int MC, int NC, int KS = 3, bool PRO = false>
__global__ void __launch_bounds__(kDwTcThreads, 2)
conv3x3_dw_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                     float* __restrict__ out, int B, int H, int W, int C,
                     int Cout, int tps, int vec,
                     const float* __restrict__ pro_gh) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int XS = padded_row(MC), GS = padded_row(NC), GCH = NC / 8;
  constexpr int NU = NC / 16, U = MC / 16 * NU, SUBS = kDwTcWarps / U;
  constexpr int R = KS / 2, XW = kDwTcTW + KS - 1, TAPS = KS * KS;
  constexpr int XE = (kDwTcTH + KS - 1) * XW * XS;
  constexpr int STAGE = XE + kDwTcTH * kDwTcTW * GS;
  const int tiles_w = (W + kDwTcTW - 1) / kDwTcTW;
  const int tiles_img = tiles_w * ((H + kDwTcTH - 1) / kDwTcTH);
  const int split = blockIdx.x, c0 = blockIdx.y * MC, co0 = blockIdx.z * NC;
  const int t0 = split * tps, t1 = min(B * tiles_img, t0 + tps);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int unit = warp % U, sub = warp / U;
  const int mi = unit / NU, ni = unit % NU;
  bf16* base = reinterpret_cast<bf16*>(smem);

  auto stage = [&](int t, int buf) {
    const int b = t / tiles_img, tile = t % tiles_img;
    const int r0 = (tile / tiles_w) * kDwTcTH, cc0 = (tile % tiles_w) * kDwTcTW;
    bf16* xs = base + buf * STAGE;
    stage_halo_bf16<XW, R>(xs, x + (size_t)b * H * W * C, r0, cc0,
                           kDwTcTH + KS - 1, c0, MC, XS, H, W, C, vec != 0);
    bf16* gs = xs + XE;
    for (int i = threadIdx.x; i < kDwTcTH * kDwTcTW * GCH; i += kDwTcThreads) {
      const int q = i % GCH, p = i / GCH;
      const int r = r0 + p / kDwTcTW, c = cc0 + p % kDwTcTW;
      const bool in = r < H && c < W;
      const size_t off =
          in ? (((size_t)b * H + r) * W + c) * Cout + co0 + q * 8 : 0;
      cp_async16(smem_addr(gs + p * GS + q * 8), g + off, in);
    }
  };

  // A = x^T of a tile row by ldmatrix.x4.trans: lane l gives the row
  // address of pixel (l % 8) + 8 (l / 16), channels 8 ((l / 8) % 2) of the
  // unit's 16, so that matrix i holds (channels 8 (i % 2), pixels
  // 8 (i / 2)) and its transpose is fragment a_i
  const int a_off = ((lane & 7) + ((lane >> 4) << 3)) * XS + mi * 16 +
                    (((lane >> 3) & 1) << 3);
  // B = g [pixel][co], as b_lane_addr addresses it
  const int b_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * GS + ni * 16 +
                    ((lane >> 4) << 3);
  float acc[TAPS][2][4] = {};
  stage(t0, 0);
  cp_async_commit();
  for (int t = t0; t < t1; ++t) {
    const int buf = (t - t0) & 1;
    if (t + 1 < t1) {
      stage(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if constexpr (PRO) {
      const int b = t / tiles_img, tile = t % tiles_img;
      pro_halo_bf16<XW, R>(base + buf * STAGE, pro_gh + (size_t)b * 2 * C,
                           (tile / tiles_w) * kDwTcTH,
                           (tile % tiles_w) * kDwTcTW, kDwTcTH + KS - 1, c0,
                           MC, XS, H, W, C);
    }
    __syncthreads();
    const bf16* xs = base + buf * STAGE;
    const bf16* gs = xs + XE;
    for (int rr = sub; rr < kDwTcTH; rr += SUBS) {
      uint32_t bfr[4];
      ldmatrix_x4_trans(bfr, smem_addr(gs + rr * kDwTcTW * GS + b_off));
#pragma unroll
      for (int tap = 0; tap < TAPS; ++tap) {
        uint32_t af[4];
        ldmatrix_x4_trans(
            af, smem_addr(xs + ((rr + tap / KS) * XW + tap % KS) * XS +
                          a_off));
        mma_16816(acc[tap][0], af, bfr[0], bfr[1]);
        mma_16816(acc[tap][1], af, bfr[2], bfr[3]);
      }
    }
    __syncthreads();
  }

  // accumulator (tap, n, 2h + e) is dw[tap][mi*16 + gq + 8h][ni*16 + 8n + 2tq + e]
  const int gq = lane >> 2, tq = lane & 3;
  out += (size_t)split * TAPS * C * Cout;
  if constexpr (SUBS == 1) {
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = c0 + mi * 16 + gq + 8 * h;
        if (ci >= C) continue;
        float* p = out + ((size_t)tap * C + ci) * Cout + co0 + ni * 16 + 2 * tq;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          p[8 * n] = acc[tap][n][2 * h];
          p[8 * n + 1] = acc[tap][n][2 * h + 1];
        }
      }
  } else {
    // the warps of a unit add their sums in the order of `sub`; the stage
    // buffers are free after the loop's last __syncthreads
    float* red = reinterpret_cast<float*>(smem);  // [TAPS][MC][NC]
    for (int s = 0; s < SUBS; ++s) {
      if (sub == s) {
#pragma unroll
        for (int tap = 0; tap < TAPS; ++tap)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int i = (tap * MC + mi * 16 + gq + 8 * (k >> 1)) * NC +
                            ni * 16 + 8 * n + 2 * tq + (k & 1);
              red[i] = s == 0 ? acc[tap][n][k] : red[i] + acc[tap][n][k];
            }
      }
      __syncthreads();
    }
    for (int o = threadIdx.x; o < TAPS * MC * NC; o += kDwTcThreads) {
      const int co = o % NC, ci = (o / NC) % MC, tap = o / (NC * MC);
      if (c0 + ci < C) out[((size_t)tap * C + c0 + ci) * Cout + co0 + co] = red[o];
    }
  }
}

// dw[i] = the sum of the nsplit partials part[s][i], in the order of s
__global__ void __launch_bounds__(256)
dw_tc_reduce_kernel(const float* __restrict__ part, int nsplit, int n,
                    float* __restrict__ dw) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < nsplit; ++t) s += part[(size_t)t * n + i];
    dw[i] = s;
  }
}

template <int MC, int NC, int KS, bool PRO>
cudaError_t dw_tc_launch(const bf16* x, const bf16* g, float* out, int B,
                         int H, int W, int C, int Cout, int nsplit, int tps,
                         cudaStream_t s, const float* pro_gh) {
  const dim3 grid(nsplit, (C + MC - 1) / MC, Cout / NC);
  const int vec = C % 8 == 0 && (uintptr_t)x % 16 == 0;
  return launch_opted(conv3x3_dw_tc_kernel<MC, NC, KS, PRO>, grid,
                      kDwTcThreads, dw_tc_smem(MC, NC, KS), s, x, g, out, B,
                      H, W, C, Cout, tps, vec, pro_gh);
}

// dw [KS][KS][C][Cout] float32 of x [B][H][W][C] and g [B][H][W][Cout]
// (bfloat16) on the tensor cores; part holds dw_tc_part_elems floats
// (`target` blocks in the grid, about: the CPU emulation also tries few).
// With PRO, pro_gh [B][2][C] is the (g, h) of x's norm.
// cudaErrorInvalidValue, launching nothing, for what the kernel does not
// take: Cout % 16 != 0, C < 1, g not 16-byte aligned, or a block's shared
// memory over the device's limit.
template <int KS = 3, bool PRO = false>
cudaError_t conv3x3_dw_tc(const bf16* x, const bf16* g, float* part,
                          float* dw, int B, int H, int W, int C, int Cout,
                          cudaStream_t s, int target = kDwTcTarget,
                          const float* pro_gh = nullptr) {
  if (B < 1 || H < 1 || W < 1 || (uintptr_t)g % 16 ||
      !dw_tc_takes(C, Cout, KS))
    return cudaErrorInvalidValue;
  const int mc = dw_tc_mc(C), nc = dw_tc_nc(Cout);
  int nsplit, tps;
  dw_tc_plan(B, H, W, C, Cout, &nsplit, &tps, target);
  float* out = nsplit > 1 ? part : dw;
#define SMSUT_DW_TC(MC, NC)                                                 \
  dw_tc_launch<MC, NC, KS, PRO>(x, g, out, B, H, W, C, Cout, nsplit, tps, s, \
                                pro_gh)
  cudaError_t e;
  if (mc == 32)
    e = nc == 64 ? SMSUT_DW_TC(32, 64) : nc == 32 ? SMSUT_DW_TC(32, 32)
                                                  : SMSUT_DW_TC(32, 16);
  else
    e = nc == 64 ? SMSUT_DW_TC(16, 64) : nc == 32 ? SMSUT_DW_TC(16, 32)
                                                  : SMSUT_DW_TC(16, 16);
#undef SMSUT_DW_TC
  if (e != cudaSuccess || nsplit == 1) return e;
  const int n = KS * KS * C * Cout;
  const int blocks = (n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16;
  dw_tc_reduce_kernel<<<blocks, 256, 0, s>>>(part, nsplit, n, dw);
  return cudaGetLastError();
}

}  // namespace smsut
