// The stride-1 SAME convolution on the tensor cores, NHWC bf16 in, HWIO
// bf16 weights, float32 accumulation and one rounding at the store: K2's
// bfloat16 path (conv3x3.cu routes bfloat16 here; float32 stays on the
// CUDA-core tile of conv_tile.cuh) and every conv of K3's and K6's
// bfloat16 chains (block.cu, block_bwd.cu).
//
//   y[b,i,j,co] = sum_{u,v,ci} x[b, i+u-KS/2, j+v-KS/2, ci] * w[u,v,ci,co]
//
// Bound on the H100: at the U-Net's shapes 2*9*Cin*Cout operations per
// pixel against (Cin + Cout) * 2 bytes; operations bound every conv with
// Cin*Cout >= 512 (the 989 TF/s bf16 rate), bytes the narrowest ones of the
// 256^2 level.
//
// Design: the dots kernel of conv3x3_mma.cu (nine tap products of
// mma.sync.m16n8k16 per 16-pixel tile, operands by ldmatrix from
// 16-byte-padded shared-memory rows), changed where it lost time or could
// not take the U-Net's shapes:
// - a block computes a tile of TH image rows x 16 columns (one mma M tile
//   per tile row) times NCO output channels, on a grid of
//   B * ceil(H/TH) * ceil(W/16) x Cout/NCO; the last band and column tile
//   are clipped at the store, so any H and W are taken, and at W = 16 the
//   warps still have rows to share;
// - the 8 warps split the tile WM (rows) x WN (channels); a warp owns MT
//   tile rows and NCO/WN channels, so one ldmatrix.trans of weights feeds
//   MT products and one ldmatrix of x feeds NCO/WN/8;
// - the input channels run in chunks of KC (a multiple of 16): per chunk
//   the (TH+KS-1) x (16+KS-1) pixel halo of x and the [KS*KS][KC][NCO]
//   weight slice are staged by cp.async, and where Cin takes more than one
//   chunk the next chunk is staged into a second buffer while this one's
//   products run.  KC is the widest that keeps the block within
//   kTcSmemTarget (two blocks per SM), so no Cin is too wide for shared
//   memory;
// - Cin is zero-padded to a multiple of 16 in both staged operands (Cin = 8
//   is one k16 step, half zeros); where Cin % 8 != 0 x is staged by element
//   loads (stage_halo_bf16); NCO = 8 (Cout 8, the dx of the U-Net's first
//   conv) takes its B fragment by ldmatrix.x2.trans;
// - per shape (tc_fwd_plan): the widest NCO dividing Cout, then the
//   tallest tile (TH 32 down to 4) whose grid still covers the SMs.
//
// Options of the template, those of conv_tile.cuh, for the block chains
// (all off: K2's kernel):
//   KS:    3, or 1 (the shortcut's 1x1 conv: the halo is the tile, one tap);
//   OutT:  bf16, or float (K6's shortcut term du @ ws^T);
//   STATS: the epilogue also sums y and y^2 per channel over the tile's
//          pixels inside the map, from the float32 accumulators (not the
//          rounded outputs), and writes them as the tile's partial
//          [B][ntiles][2][Cout] (tc_fwd_ntiles): the lane's rows and column
//          halves in registers, then the eight row groups of the warp by
//          __shfl_xor over lane bits 4, 8, 16, then the WM warps in shared
//          memory in a fixed order.  No atomics: runs agree bit for bit;
//   PRO:   x is the previous conv's stored output, and each staged chunk is
//          normalised and activated in shared memory once its copies have
//          landed (pro_halo_bf16, norm_act<bf16> with that norm's (g, h)),
//          while the next chunk's copies are in flight; the padding stays 0;
//   EPI:   kEpiAdd adds a float32 map [B][H][W][Cout] before the one
//          rounding (K6's dx); kEpiMask multiplies by lrelu'(z), z =
//          norm_act<bf16>(y, g, h) of a stored bf16 conv output y
//          [B][H][W][Cout] and its norm's (g, h) (K6's dz1 masked by z1).
// Not yet: wgmma, TMA, a persistent grid or a staged epilogue.
#pragma once

#include "mma_tile.cuh"

namespace smsut {

constexpr int kTcThreads = 256;
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcTW = 16;           // tile width: one mma M tile per row
// a block's shared memory at most, so that two blocks share an SM
constexpr size_t kTcSmemTarget = 112 * 1024;

// One block shape of the forward: NCO output channels, WN warps along
// them, MT tile rows per warp (TH = 8 / WN * MT rows).
struct TcFwdCfg {
  int nco, wn, mt;
};
// per NCO, from the tallest tile to the shortest
constexpr TcFwdCfg kTcFwdCfgs[] = {
    {64, 2, 4}, {64, 2, 2}, {64, 4, 2},  // TH 16, 8, 4
    {32, 1, 2}, {32, 2, 2}, {32, 2, 1},  // TH 16, 8, 4
    {16, 1, 4}, {16, 1, 2}, {16, 1, 1},  // TH 32, 16, 8
    {8, 1, 4},  {8, 1, 2},  {8, 1, 1}};  // TH 32, 16, 8
constexpr int kTcFwdNCfgs = sizeof(kTcFwdCfgs) / sizeof(kTcFwdCfgs[0]);

inline int tc_fwd_th(const TcFwdCfg& c) { return kTcWarps / c.wn * c.mt; }

// shared memory of one block at chunk width KC with nbuf stage buffers
inline size_t tc_fwd_smem(const TcFwdCfg& c, int KC, int nbuf, int ks = 3) {
  return (size_t)nbuf *
         ((tc_fwd_th(c) + ks - 1) * (kTcTW + ks - 1) * (KC + 8) +
          ks * ks * KC * padded_row(c.nco)) *
         sizeof(bf16);
}

struct TcFwdPlan {
  int cfg, KC, nchunks;
  size_t smem;
};

// The block shape and channel chunk of a shape; cfg >= 0 forces that entry
// of kTcFwdCfgs (its NCO must divide Cout).  False where nothing fits
// within min(optin, kTcSmemTarget) bytes.
inline bool tc_fwd_plan(int B, int H, int W, int C, int Cout, size_t optin,
                        int cfg, TcFwdPlan* p, int ks = 3) {
  if (cfg < 0) {
    const int nco = Cout % 64 == 0 ? 64 : Cout % 32 == 0 ? 32
                    : Cout % 16 == 0 ? 16 : 8;
    for (int i = 0; i < kTcFwdNCfgs; ++i) {
      if (kTcFwdCfgs[i].nco != nco) continue;
      cfg = i;
      const int th = tc_fwd_th(kTcFwdCfgs[i]);
      const long long grid = (long long)B * ((H + th - 1) / th) *
                             ((W + kTcTW - 1) / kTcTW) * (Cout / nco);
      if (grid >= kSMs) break;
    }
  }
  if (cfg >= kTcFwdNCfgs || Cout % kTcFwdCfgs[cfg].nco) return false;
  const TcFwdCfg& c = kTcFwdCfgs[cfg];
  const size_t budget = optin < kTcSmemTarget ? optin : kTcSmemTarget;
  const int CP = (C + 15) / 16 * 16;
  p->cfg = cfg;
  if (tc_fwd_smem(c, CP, 1, ks) <= budget) {
    p->KC = CP;
    p->nchunks = 1;
    p->smem = tc_fwd_smem(c, CP, 1, ks);
    return true;
  }
  for (int KC = CP - 16; KC >= 16; KC -= 16) {
    if (tc_fwd_smem(c, KC, 2, ks) <= budget) {
      p->KC = KC;
      p->nchunks = (CP + KC - 1) / KC;
      p->smem = tc_fwd_smem(c, KC, 2, ks);
      return true;
    }
  }
  return false;
}

// the tiles of one image under a plan: the partials per sample of STATS
inline int tc_fwd_ntiles(const TcFwdPlan& p, int H, int W) {
  const int th = tc_fwd_th(kTcFwdCfgs[p.cfg]);
  return ((H + th - 1) / th) * ((W + kTcTW - 1) / kTcTW);
}

// Whether the kernel takes the shape (Cout % 8 == 0, within the device's
// shared memory), and its plan: the checks of conv3x3_tc but the pointers'.
inline bool tc_fwd_takes(int B, int H, int W, int C, int Cout, int cfg,
                         int ks, TcFwdPlan* p) {
  return B >= 1 && H >= 1 && W >= 1 && C >= 1 && Cout >= 8 && Cout % 8 == 0 &&
         tc_fwd_plan(B, H, W, C, Cout, smem_optin_bytes(), cfg, p, ks);
}

// The operands of the options (null where an option is off).
struct TcOpts {
  float* part;           // STATS: [B][ntiles][2][Cout]
  const float* pro_gh;   // PRO: [B][2][C], (g, h) of x's norm
  const void* epi;       // kEpiAdd: float [B][H][W][Cout]; kEpiMask: bf16 y
  const float* epi_gh;   // kEpiMask: [B][2][Cout], (g, h) of y's norm
};

// Stage the weight rows of input channels k0 .. k0+KC-1 (zero at >= C) and
// output channels co0 .. co0+NCO-1: w [TAPS][C][Cout] -> w_s [TAPS*KC][NS].
template <int NCO, int TAPS = 9>
__device__ __forceinline__ void tc_stage_weights(bf16* w_s,
                                                 const bf16* __restrict__ w,
                                                 int k0, int KC, int C,
                                                 int Cout, int co0) {
  constexpr int CH = NCO / 8, NS = padded_row(NCO);
  const int n = TAPS * KC * CH;
  for (int i = threadIdx.x; i < n; i += kTcThreads) {
    const int c = i % CH, r = i / CH;  // r = tap * KC + k
    const int ci = k0 + r % KC;
    const size_t off = ci < C ? ((size_t)(r / KC) * C + ci) * Cout + co0 + c * 8
                              : 0;
    cp_async16(smem_addr(w_s + r * NS + c * 8), w + off, ci < C);
  }
}

__device__ __forceinline__ void tc_store2(bf16* p, float a, float b) {
  store_bf16x2(p, a, b);
}
__device__ __forceinline__ void tc_store2(float* p, float a, float b) {
  p[0] = a;
  p[1] = b;
}

// One block: tile rows r0 .. r0+TH-1, columns c0 .. c0+15 of image b,
// output channels co0 .. co0+NCO-1.  Warp (wm, wn) owns tile rows
// wm*MT .. wm*MT+MT-1 and channels wn*NTW*8 .. +NTW*8-1.  Per chunk k the
// stage buffer k % 2 holds the halo x_s [(TH+KS-1)*XW][KC+8] (pixel (r, c)
// of the halo at row r*XW + c, XW = 16+KS-1) and the weights
// w_s [KS*KS*KC][NS].
template <int NCO, int WN, int MT, int KS = 3, typename OutT = bf16,
          bool STATS = false, bool PRO = false, int EPI = kEpiNone>
__global__ void __launch_bounds__(kTcThreads, 2)
conv3x3_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  OutT* __restrict__ y, int H, int W, int C, int Cout, int KC,
                  int nchunks, int vec, TcOpts o) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int WM = kTcWarps / WN, TH = WM * MT, NTW = NCO / WN / 8;
  constexpr int NS = padded_row(NCO);
  constexpr int R = KS / 2, XW = kTcTW + KS - 1, TAPS = KS * KS;
  const int PS = KC + 8, CP = (C + 15) / 16 * 16;
  const int xs_elems = (TH + KS - 1) * XW * PS;
  const int stage_elems = xs_elems + TAPS * KC * NS;
  const int tiles_w = (W + kTcTW - 1) / kTcTW, bands = (H + TH - 1) / TH;
  const int b = blockIdx.x / (bands * tiles_w);
  const int rem = blockIdx.x % (bands * tiles_w);
  const int r0 = (rem / tiles_w) * TH, c0 = (rem % tiles_w) * kTcTW;
  const int co0 = blockIdx.y * NCO;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const bf16* xb = x + (size_t)b * H * W * C;
  bf16* base = reinterpret_cast<bf16*>(smem);

  auto stage = [&](int k) {
    bf16* xs = base + (k & 1) * stage_elems;
    stage_halo_bf16<XW, R>(xs, xb, r0, c0, TH + KS - 1, k * KC, KC, PS, H, W,
                           C, vec != 0);
    tc_stage_weights<NCO, TAPS>(xs + xs_elems, w, k * KC, KC, C, Cout, co0);
  };

  float acc[MT][NTW][4] = {};
  stage(0);
  cp_async_commit();
  for (int k = 0; k < nchunks; ++k) {
    if (k + 1 < nchunks) {
      stage(k + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const bf16* xs = base + (k & 1) * stage_elems;
    if constexpr (PRO)
      pro_halo_bf16<XW, R>(base + (k & 1) * stage_elems,
                           o.pro_gh + (size_t)b * 2 * C, r0, c0, TH + KS - 1,
                           k * KC, KC, PS, H, W, C);
    __syncthreads();
    const bf16* ws = xs + xs_elems;
    // lane's A row: pixel lane % 16 of tile row wm*MT (+ i), k half lane/16
    const uint32_t a0 = smem_addr(xs + (wm * MT * XW + (lane & 15)) * PS +
                                  ((lane >> 4) << 3));
    const uint32_t bq = b_lane_addr(ws + wn * NTW * 8, NS, lane);
    const uint32_t b1 = smem_addr(ws + (lane & 15) * NS + (wn * NTW + NTW - 1) * 8);
    const int kq = min(KC, CP - k * KC) / 16;
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      const uint32_t at = a0 + (uint32_t)(((tap / KS) * XW + tap % KS) * PS * 2);
      const uint32_t bt = (uint32_t)(tap * KC * NS * 2);
      for (int ks = 0; ks < kq; ++ks) {
        uint32_t bf[NTW][2];
#pragma unroll
        for (int j = 0; j < NTW / 2; ++j) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, bq + bt + ks * 16 * NS * 2 + j * 32);
          bf[2 * j][0] = r[0];
          bf[2 * j][1] = r[1];
          bf[2 * j + 1][0] = r[2];
          bf[2 * j + 1][1] = r[3];
        }
        if constexpr (NTW % 2 == 1)
          ldmatrix_x2_trans(bf[NTW - 1], b1 + bt + ks * 16 * NS * 2);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t af[4];
          ldmatrix_x4(af, at + (uint32_t)((i * XW * PS + ks * 16) * 2));
#pragma unroll
          for (int n = 0; n < NTW; ++n) mma_16816(acc[i][n], af, bf[n][0], bf[n][1]);
        }
      }
    }
    __syncthreads();
  }

  // accumulator (i, n, 2h + e) is y at row r0 + wm*MT + i, column
  // c0 + g + 8h, channel co0 + wn*NTW*8 + 8n + 2t + e
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = r0 + wm * MT + i;
    if (row >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c0 + g + 8 * h;
      if (col >= W) continue;
      const int cw = co0 + wn * NTW * 8 + 2 * t;
      const size_t e0 = (((size_t)b * H + row) * W + col) * Cout + cw;
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const size_t e = e0 + n * 8;
        float v0 = acc[i][n][2 * h], v1 = acc[i][n][2 * h + 1];
        if constexpr (EPI == kEpiAdd) {
          const float* a = static_cast<const float*>(o.epi) + e;
          v0 += a[0];
          v1 += a[1];
        }
        if constexpr (EPI == kEpiMask) {
          const bf16* yv = static_cast<const bf16*>(o.epi) + e;
          const float* gh = o.epi_gh + (size_t)b * 2 * Cout;
          const int c = cw + n * 8;
          v0 *= lrelu_grad(norm_act<bf16>(to_f(yv[0]), gh[c], gh[Cout + c]));
          v1 *= lrelu_grad(
              norm_act<bf16>(to_f(yv[1]), gh[c + 1], gh[Cout + c + 1]));
        }
        tc_store2(y + e, v0, v1);
      }
    }
  }
  if constexpr (STATS) {
    // s[n][e], s[n][2 + e]: sum and sum of squares of channel 8n + 2t + e
    float s[NTW][4] = {};
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (r0 + wm * MT + i >= H || c0 + g + 8 * h >= W) continue;
#pragma unroll
        for (int n = 0; n < NTW; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = acc[i][n][2 * h + e];
            s[n][e] += v;
            s[n][2 + e] += v * v;
          }
      }
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int m = 4; m <= 16; m <<= 1)
          s[n][q] += __shfl_xor_sync(0xffffffffu, s[n][q], m);
    // [WM][2][NCO]: the stage buffers are free after the loop's last
    // __syncthreads
    float* red = reinterpret_cast<float*>(smem);
    if (g == 0) {
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = wn * NTW * 8 + 8 * n + 2 * t + e;
          red[wm * 2 * NCO + c] = s[n][e];
          red[(wm * 2 + 1) * NCO + c] = s[n][2 + e];
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * NCO; i += kTcThreads) {
      float v = 0.f;
      for (int m = 0; m < WM; ++m) v += red[m * 2 * NCO + i];
      const int which = i / NCO, c = i % NCO;
      o.part[(((size_t)b * bands * tiles_w + rem) * 2 + which) * Cout + co0 +
             c] = v;
    }
  }
}

template <int NCO, int WN, int MT, int KS, typename OutT, bool STATS,
          bool PRO, int EPI>
cudaError_t tc_fwd_launch(const TcFwdPlan& p, const bf16* x, const bf16* w,
                          OutT* y, int B, int H, int W, int C, int Cout,
                          cudaStream_t s, const TcOpts& o) {
  constexpr int TH = kTcWarps / WN * MT;
  const dim3 grid(B * ((H + TH - 1) / TH) * ((W + kTcTW - 1) / kTcTW),
                  Cout / NCO);
  const int vec = C % 8 == 0 && (uintptr_t)x % 16 == 0;
  return launch_opted(
      conv3x3_tc_kernel<NCO, WN, MT, KS, OutT, STATS, PRO, EPI>, grid,
      kTcThreads, p.smem, s, x, w, y, H, W, C, Cout, p.KC, p.nchunks, vec, o);
}

// y = conv(x, w) on the tensor cores, with the options of the template
// and their operands in o.  cfg < 0 picks the block shape (tc_fwd_plan);
// cfg >= 0 forces one (the CPU emulation tries each).
// cudaErrorInvalidValue, launching nothing, for what the kernel does not
// take: Cout % 8 != 0, C < 1, w not 16-byte aligned, or no chunk that fits
// the device's shared memory.
template <int KS = 3, typename OutT = bf16, bool STATS = false,
          bool PRO = false, int EPI = kEpiNone>
cudaError_t conv3x3_tc(const bf16* x, const bf16* w, OutT* y, int B, int H,
                       int W, int C, int Cout, cudaStream_t s, int cfg = -1,
                       const TcOpts& o = TcOpts{}) {
  TcFwdPlan p;
  if ((uintptr_t)w % 16 || (uintptr_t)y % (2 * sizeof(OutT)) ||
      !tc_fwd_takes(B, H, W, C, Cout, cfg, KS, &p))
    return cudaErrorInvalidValue;
#define SMSUT_TC_FWD(I, NCO, WN, MT)                                        \
  case I:                                                                   \
    return tc_fwd_launch<NCO, WN, MT, KS, OutT, STATS, PRO, EPI>(           \
        p, x, w, y, B, H, W, C, Cout, s, o);
  switch (p.cfg) {
    SMSUT_TC_FWD(0, 64, 2, 4)
    SMSUT_TC_FWD(1, 64, 2, 2)
    SMSUT_TC_FWD(2, 64, 4, 2)
    SMSUT_TC_FWD(3, 32, 1, 2)
    SMSUT_TC_FWD(4, 32, 2, 2)
    SMSUT_TC_FWD(5, 32, 2, 1)
    SMSUT_TC_FWD(6, 16, 1, 4)
    SMSUT_TC_FWD(7, 16, 1, 2)
    SMSUT_TC_FWD(8, 16, 1, 1)
    SMSUT_TC_FWD(9, 8, 1, 4)
    SMSUT_TC_FWD(10, 8, 1, 2)
    SMSUT_TC_FWD(11, 8, 1, 1)
  }
#undef SMSUT_TC_FWD
  return cudaErrorInvalidValue;
}

// The tiles per image (the STATS partials per sample) of the plan
// conv3x3_tc picks for a shape; 0 where it refuses the shape.
inline int tc_fwd_tiles(int B, int H, int W, int C, int Cout, int ks) {
  TcFwdPlan p;
  return tc_fwd_takes(B, H, W, C, Cout, -1, ks, &p) ? tc_fwd_ntiles(p, H, W)
                                                    : 0;
}

}  // namespace smsut
