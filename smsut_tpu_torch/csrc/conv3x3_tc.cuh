// K2's bfloat16 path: the 3x3 stride-1 SAME convolution on the tensor
// cores, NHWC bf16 in and out, HWIO bf16 weights, float32 accumulation and
// one rounding to bf16 at the store.  conv3x3.cu routes bfloat16 here;
// float32 stays on the CUDA-core tile of conv_tile.cuh.
//
//   y[b,i,j,co] = sum_{u,v,ci} x[b, i+u-1, j+v-1, ci] * w[u,v,ci,co]
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
//   the (TH+2) x 18 pixel halo of x and the [9][KC][NCO] weight slice are
//   staged by cp.async, and where Cin takes more than one chunk the next
//   chunk is staged into a second buffer while this one's products run.
//   KC is the widest that keeps the block within kTcSmemTarget (two blocks
//   per SM), so no Cin is too wide for shared memory;
// - Cin is zero-padded to a multiple of 16 in both staged operands (Cin = 8
//   is one k16 step, half zeros); where Cin % 8 != 0 x is staged by element
//   loads (stage_halo_bf16); NCO = 8 (Cout 8, the dx of the U-Net's first
//   conv) takes its B fragment by ldmatrix.x2.trans;
// - per shape (tc_fwd_plan): the widest NCO dividing Cout, then the
//   tallest tile (TH 32 down to 4) whose grid still covers the SMs.
// Not yet: wgmma, TMA, a persistent grid or a staged epilogue.
#pragma once

#include "mma_tile.cuh"

namespace smsut {

constexpr int kTcThreads = 256;
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcTW = 16;           // tile width: one mma M tile per row
constexpr int kTcHaloW = kTcTW + 2;
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
inline size_t tc_fwd_smem(const TcFwdCfg& c, int KC, int nbuf) {
  return (size_t)nbuf *
         ((tc_fwd_th(c) + 2) * kTcHaloW * (KC + 8) +
          9 * KC * padded_row(c.nco)) *
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
                        int cfg, TcFwdPlan* p) {
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
  if (tc_fwd_smem(c, CP, 1) <= budget) {
    p->KC = CP;
    p->nchunks = 1;
    p->smem = tc_fwd_smem(c, CP, 1);
    return true;
  }
  for (int KC = CP - 16; KC >= 16; KC -= 16) {
    if (tc_fwd_smem(c, KC, 2) <= budget) {
      p->KC = KC;
      p->nchunks = (CP + KC - 1) / KC;
      p->smem = tc_fwd_smem(c, KC, 2);
      return true;
    }
  }
  return false;
}

// Stage the weight rows of input channels k0 .. k0+KC-1 (zero at >= C) and
// output channels co0 .. co0+NCO-1: w [9][C][Cout] -> w_s [9][KC][NS].
template <int NCO>
__device__ __forceinline__ void tc_stage_weights(bf16* w_s,
                                                 const bf16* __restrict__ w,
                                                 int k0, int KC, int C,
                                                 int Cout, int co0) {
  constexpr int CH = NCO / 8, NS = padded_row(NCO);
  const int n = 9 * KC * CH;
  for (int i = threadIdx.x; i < n; i += kTcThreads) {
    const int c = i % CH, r = i / CH;  // r = tap * KC + k
    const int ci = k0 + r % KC;
    const size_t off = ci < C ? ((size_t)(r / KC) * C + ci) * Cout + co0 + c * 8
                              : 0;
    cp_async16(smem_addr(w_s + r * NS + c * 8), w + off, ci < C);
  }
}

// One block: tile rows r0 .. r0+TH-1, columns c0 .. c0+15 of image b,
// output channels co0 .. co0+NCO-1.  Warp (wm, wn) owns tile rows
// wm*MT .. wm*MT+MT-1 and channels wn*NTW*8 .. +NTW*8-1.  Per chunk k the
// stage buffer k % 2 holds the halo x_s [(TH+2)*18][KC+8] (pixel (r, c) of
// the halo at row r*18 + c) and the weights w_s [9*KC][NS].
template <int NCO, int WN, int MT>
__global__ void __launch_bounds__(kTcThreads, 2)
conv3x3_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  bf16* __restrict__ y, int H, int W, int C, int Cout, int KC,
                  int nchunks, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int WM = kTcWarps / WN, TH = WM * MT, NTW = NCO / WN / 8;
  constexpr int NS = padded_row(NCO);
  const int PS = KC + 8, CP = (C + 15) / 16 * 16;
  const int xs_elems = (TH + 2) * kTcHaloW * PS;
  const int stage_elems = xs_elems + 9 * KC * NS;
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
    stage_halo_bf16<kTcHaloW>(xs, xb, r0, c0, TH + 2, k * KC, KC, PS, H, W,
                              C, vec != 0);
    tc_stage_weights<NCO>(xs + xs_elems, w, k * KC, KC, C, Cout, co0);
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
    __syncthreads();
    const bf16* xs = base + (k & 1) * stage_elems;
    const bf16* ws = xs + xs_elems;
    // lane's A row: pixel lane % 16 of tile row wm*MT (+ i), k half lane/16
    const uint32_t a0 = smem_addr(xs + (wm * MT * kTcHaloW + (lane & 15)) * PS +
                                  ((lane >> 4) << 3));
    const uint32_t bq = b_lane_addr(ws + wn * NTW * 8, NS, lane);
    const uint32_t b1 = smem_addr(ws + (lane & 15) * NS + (wn * NTW + NTW - 1) * 8);
    const int kq = min(KC, CP - k * KC) / 16;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t at = a0 + (uint32_t)(((tap / 3) * kTcHaloW + tap % 3) * PS * 2);
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
          ldmatrix_x4(af, at + (uint32_t)((i * kTcHaloW * PS + ks * 16) * 2));
#pragma unroll
          for (int n = 0; n < NTW; ++n) mma_16816(acc[i][n], af, bf[n][0], bf[n][1]);
        }
      }
    }
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = r0 + wm * MT + i;
    if (row >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c0 + g + 8 * h;
      if (col >= W) continue;
      bf16* p = y + (((size_t)b * H + row) * W + col) * Cout + co0 +
                wn * NTW * 8 + 2 * t;
#pragma unroll
      for (int n = 0; n < NTW; ++n)
        store_bf16x2(p + n * 8, acc[i][n][2 * h], acc[i][n][2 * h + 1]);
    }
  }
}

template <int NCO, int WN, int MT>
cudaError_t tc_fwd_launch(const TcFwdPlan& p, const bf16* x, const bf16* w,
                          bf16* y, int B, int H, int W, int C, int Cout,
                          cudaStream_t s) {
  static std::atomic<uint64_t> opted{0};
  constexpr int TH = kTcWarps / WN * MT;
  const dim3 grid(B * ((H + TH - 1) / TH) * ((W + kTcTW - 1) / kTcTW),
                  Cout / NCO);
  const int vec = C % 8 == 0 && (uintptr_t)x % 16 == 0;
  return launch_opted(conv3x3_tc_kernel<NCO, WN, MT>, opted, grid,
                      kTcThreads, p.smem, s, x, w, y, H, W, C, Cout, p.KC,
                      p.nchunks, vec);
}

// y = conv(x, w) in bfloat16 on the tensor cores.  cfg < 0 picks the block
// shape (tc_fwd_plan); cfg >= 0 forces one (the CPU emulation tries each).
// cudaErrorInvalidValue, launching nothing, for what the kernel does not
// take: Cout % 8 != 0, C < 1, w not 16-byte aligned, or no chunk that fits
// the device's shared memory.
inline cudaError_t conv3x3_tc(const bf16* x, const bf16* w, bf16* y, int B,
                              int H, int W, int C, int Cout, cudaStream_t s,
                              int cfg = -1) {
  TcFwdPlan p;
  if (B < 1 || H < 1 || W < 1 || C < 1 || Cout < 8 || Cout % 8 ||
      (uintptr_t)w % 16 || (uintptr_t)y % 4 ||
      !tc_fwd_plan(B, H, W, C, Cout, smem_optin_bytes(), cfg, &p))
    return cudaErrorInvalidValue;
#define SMSUT_TC_FWD(I, NCO, WN, MT) \
  case I:                            \
    return tc_fwd_launch<NCO, WN, MT>(p, x, w, y, B, H, W, C, Cout, s);
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

}  // namespace smsut
