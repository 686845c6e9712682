// K8 and K9 on Hopper: the two im2col conv candidates of
// tools/microbench_pallas_conv.py, `pallas_conv_im2col` (:99, kernel
// `_im2col_kernel` :82) and `pallas_conv_im2col2` (:139, `_im2col2_kernel`
// :120).  Both compute y = 3x3 SAME conv, NHWC bf16 in and out, HWIO bf16
// weights, float32 accumulation and one rounding at the store, as one
// K = 9C contraction per pixel tile into one accumulator.  They differ as
// the Pallas pair does, in one thing: whether the copy of the next input
// overlaps the products (ASYNC).
//
// Bound on the H100 at the microbench's shape x [16,128,128,64] -> 64:
// 0.0201 ms of bytes (x and y 33.5 MB each) against 0.0195 ms of bf16
// operations, so x must be read about once and the tensor cores kept busy.
// The design:
//   - the product is taken transposed, y^T = W^T x^T: wgmma.m64n128k16
//     with M = 64 output channels (a Cout block; Cout 16-48 pads it with
//     the box's zeros) and N = 128 pixels of one image row, both operands
//     in shared memory.  A wgmma as narrow as Cout (m64n64k16, pixels as
//     M) ran at under half the tensor cores' rate on the H100;
//   - a persistent grid of at most one block per SM (132) per Cout block
//     walks (image, band of rows, 128-column segment) units; the band
//     height is picked from the shape so the units cover the card,
//     whatever `strip`;
//   - one producer warp issues TMA loads; three consumer warpgroups take
//     the band's rows in turn (row i to warpgroup i % 3), so one's
//     epilogue runs under the others' products;
//   - the weights [9C][64] land once per block by TMA, 128-byte swizzled,
//     and are read as A through descriptors (M contiguous);
//   - x streams through a ring of input rows: slot = one image row of the
//     segment, 130 pixels (the box's out-of-bounds fill gives the zero
//     border at columns -1 and W and rows -1 and H) x 64 channels, one
//     128-byte swizzle row per pixel.  C = 16, 32 or 48 fill the 64-channel
//     row with the box's zeros, and C > 64 takes one box per 64 channels;
//     the products always run the box's four k16 steps (zero channels
//     against zero weight rows: C = 16 does 4x its work).  B is read in
//     place through descriptors (K contiguous): the tap's column shift and
//     the k16 step move the descriptor's start by 128 and 32 bytes, and the
//     swizzle follows the absolute address, as TMA wrote it, so the
//     [64, 9C] column tile of the Pallas kernels is never built.  A band of
//     rb output rows reads rb + 2 rows: x crosses L2 about (rb + 2) / rb
//     times (1.125 at the microbench's 16-row bands);
//   - full/empty mbarrier pairs guard the slots.  Output row i needs input
//     rows i-1 .. i+1; a warpgroup releases the rows its next row does not
//     read.  K8 (im2col) keeps three slots, exactly one row's window: the
//     next row's load waits for the release of the row before, and its
//     products for that load, so copy and compute do not overlap (nor do
//     the two warpgroups' rows).  K9 (im2col2) keeps 4 to 8, the next rows'
//     loads in flight while the products run;
//   - the epilogue rounds each float32 sum once to bf16, turns each warp's
//     16 channels x 64 pixels at a time to pixel-major in shared memory
//     (stmatrix.trans), and stores 16 bytes a lane, masked at the ragged W
//     and Cout edges.  No atomics: two runs give the same bits.
#pragma once

#include <algorithm>

#include "sm90.cuh"

namespace smsut {

constexpr int kIm2colWarpgroups = 3;                   // consumers
constexpr int kIm2colThreads = 128 * kIm2colWarpgroups + 32;
constexpr int kIm2colMaxSlots = 8;
constexpr int kIm2colPx = 128;       // pixels per tile: the wgmma's N
constexpr int kIm2colCo = 64;        // output channels per block: its M
// the epilogue turns 64 pixels at a time; a pixel's row there holds 16
// channels and 8 of padding, so that stmatrix's 8 rows take 8 bank groups
constexpr int kIm2colOutPx = 64;
constexpr int kIm2colOutStride = 24;

// The plan of one launch, the same on host and device.  It serves K7 too
// (conv3x3_dots_sm90.cuh), with two consumer warpgroups.
struct Im2colGeom {
  int H, W, C, Cout;
  int nch;            // boxes of 64 channels per staged row
  int nseg;           // 128-column segments
  int rb, nbands;     // output rows per band, bands per image
  int units, grid;    // units per Cout block, blocks per Cout block
  int slots;          // ring depth
  uint32_t wts_bytes, out_bytes, chunk_bytes, slot_bytes;
  // barriers (1 KB), the weights, the epilogue scratch and `n` slots, 1 KB
  // of alignment slack
  size_t smem(int n) const {
    return 2048 + wts_bytes + out_bytes + (size_t)n * slot_bytes;
  }
};

// The plan for x [B,H,W,C] -> Cout, on `sms` SMs within `optin` bytes of
// shared memory, for `wgs` consumer warpgroups: K8 takes 3 slots, K9 (and
// K7) as many as fit up to kIm2colMaxSlots (slots 0 where its least does
// not fit).
inline Im2colGeom im2col_geom(bool async, int B, int H, int W, int C,
                              int Cout, int sms, size_t optin,
                              int wgs = kIm2colWarpgroups) {
  Im2colGeom g{};
  g.H = H, g.W = W, g.C = C, g.Cout = Cout;
  g.nch = (C + 63) / 64;
  g.nseg = (W + kIm2colPx - 1) / kIm2colPx;
  g.wts_bytes = (uint32_t)(9 * g.nch * 64 * kIm2colCo * 2);
  g.out_bytes = (uint32_t)(4 * wgs * kIm2colOutPx * kIm2colOutStride * 2);
  g.chunk_bytes = (uint32_t)(((kIm2colPx + 2) * 128 + 1023) / 1024 * 1024);
  g.slot_bytes = g.nch * g.chunk_bytes;
  const int ncob = (Cout + kIm2colCo - 1) / kIm2colCo;
  const int per = std::max(1, sms / ncob);
  const long rows = (long)B * H * g.nseg;
  g.rb = (int)std::min<long>(H, (rows + per - 1) / per);
  g.nbands = (H + g.rb - 1) / g.rb;
  g.units = B * g.nbands * g.nseg;
  g.grid = std::min(g.units, per);
  const size_t fixed = g.smem(0);
  const int fit = optin > fixed ? (int)((optin - fixed) / g.slot_bytes) : 0;
  g.slots = async ? (fit >= 4 ? std::min(fit, kIm2colMaxSlots) : 0)
                  : (fit >= 3 ? 3 : 0);
  return g;
}

// The barriers of the ring at `base`: slot s's full and empty
__device__ __forceinline__ uint32_t ring_full(uint32_t base, int s) {
  return base + 8 + 8 * s;
}
__device__ __forceinline__ uint32_t ring_empty(uint32_t base, int s) {
  return base + 8 + 8 * kIm2colMaxSlots + 8 * s;
}

// Thread 0: the weights' full barrier at base, and per slot a full
// (the producer's arrival and the bytes) and an empty (one arrival per
// consumer warp of `wgs` warpgroups)
__device__ __forceinline__ void ring_init(uint32_t base, int slots, int wgs) {
  mbar_init(base, 1);
  for (int s = 0; s < slots; ++s) {
    mbar_init(ring_full(base, s), 1);
    mbar_init(ring_empty(base, s), 4 * wgs);
  }
  mbar_fence_init();
}

// The producer's lane: the block's weight slab once (full barrier at
// base), then the input rows of each unit of this block into the ring of
// `slots` at `ring`, each slot once its consumers have released it.
__device__ __forceinline__ void im2col_produce(const CUtensorMap* xmap,
                                               const CUtensorMap* wmap,
                                               const Im2colGeom& g,
                                               uint32_t base, uint32_t w_s,
                                               uint32_t ring, int slots,
                                               int co0) {
  mbar_arrive_expect_tx(base, g.wts_bytes);
  for (int tap = 0; tap < 9; ++tap)
    for (int q = 0; q < g.nch; ++q)
      tma_load_3d(w_s + (tap * g.nch + q) * 64 * 128, wmap, base, co0,
                  64 * q, tap);
  uint32_t n = 0;
  for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
    const int seg = u % g.nseg, band = u / g.nseg % g.nbands;
    const int b = u / (g.nseg * g.nbands);
    const int r0 = band * g.rb, rows = min(g.rb, g.H - r0);
    for (int j = 0; j < rows + 2; ++j, ++n) {
      const int s = n % slots;
      mbar_wait(ring_empty(base, s), ((n / slots) & 1) ^ 1);
      mbar_arrive_expect_tx(ring_full(base, s),
                            (uint32_t)(g.nch * (kIm2colPx + 2) * 128));
      for (int q = 0; q < g.nch; ++q)
        tma_load_4d(ring + s * g.slot_bytes + q * g.chunk_bytes, xmap,
                    ring_full(base, s), 64 * q, seg * kIm2colPx - 1,
                    r0 - 1 + j, b);
    }
  }
}

// A consumer warp's part of one output row: its 16 channels co0 + 16 wl ..
// of the warpgroup's float32 sums `acc` (channels x 128 pixels from column
// c0 of the row whose first pixel is rowpix), each rounded once to bf16,
// turned pixel-major through the warp's scratch (shared address out_a,
// generic out_w) and stored 16 bytes a lane, masked at the ragged W and
// Cout edges.
//
// Registers 4j + 2h + e hold channel 16 wl + lane / 4 + 8h of pixel
// 8j + 2 (lane % 4) + e: per n8 block j and h an 8x8 matrix (channels x
// pixels) that stmatrix stores transposed, pixel-major; lanes 8m ..
// 8m+7 address the rows of matrix m = (j - j0, h) of each x4.
__device__ __forceinline__ void im2col_store_row(
    const float (&acc)[64], bf16* __restrict__ y, size_t rowpix, int c0,
    int co0, int W, int Cout, uint32_t out_a, const bf16* out_w, int wl,
    int lane) {
  const int m = lane >> 3;
#pragma unroll
  for (int p0 = 0; p0 < kIm2colPx; p0 += kIm2colOutPx) {
#pragma unroll
    for (int j0 = p0 / 8; j0 < (p0 + kIm2colOutPx) / 8; j0 += 2) {
      uint32_t r[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + (k >> 1), h = k & 1;
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        memcpy(&r[k], &v, 4);
      }
      const int px = 8 * (j0 + (m >> 1)) - p0 + (lane & 7);
      stmatrix_x4_trans(out_a + (px * kIm2colOutStride + 8 * (m & 1)) * 2,
                        r);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 2 * kIm2colOutPx / 32; ++k) {
      const int c = lane + 32 * k, px = c >> 1, half = c & 1;
      const int col = c0 + p0 + px, co = co0 + 16 * wl + 8 * half;
      if (col < W && co < Cout)
        *reinterpret_cast<uint4*>(y + (rowpix + col) * Cout + co) =
            *reinterpret_cast<const uint4*>(out_w + px * kIm2colOutStride +
                                            8 * half);
    }
    __syncwarp();
  }
}

// A consumer warp's walk over its block's units: warpgroup wg of `wgs`
// takes rows wg, wg + wgs, .. of each unit's band, and calls
// row(rowpix, c0, src) for each once its three input rows have landed
// (rowpix the output row's first pixel, c0 the segment's first column,
// src[du] the shared address of input row i - 1 + du's slot).
//
// Ring positions below `rel` are released by this warp, each once its
// fill has landed, read or not: an arrival before the fill (a warpgroup
// without a row in a short band) would count towards the slot's next
// phase.
template <typename Row>
__device__ __forceinline__ void im2col_consume(const Im2colGeom& g,
                                               uint32_t base, uint32_t ring,
                                               int slots, int wgs, int wg,
                                               int lane, Row&& row) {
  uint32_t n = 0;
  for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
    const int seg = u % g.nseg, band = u / g.nseg % g.nbands;
    const int b = u / (g.nseg * g.nbands);
    const int r0 = band * g.rb, rows = min(g.rb, g.H - r0);
    auto slot = [&](int pos) { return (int)((n + pos) % slots); };
    int rel = 0;
    auto release = [&](int upto) {
      for (; rel < upto; ++rel) {
        mbar_wait(ring_full(base, slot(rel)), ((n + rel) / slots) & 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(ring_empty(base, slot(rel)));
      }
    };
    for (int i = wg; i < rows; i += wgs) {
      // input rows i-1 .. i+1 are ring positions i .. i+2
      release(i);
      uint32_t src[3];
#pragma unroll
      for (int du = 0; du < 3; ++du) {
        mbar_wait(ring_full(base, slot(i + du)), ((n + i + du) / slots) & 1);
        src[du] = ring + slot(i + du) * g.slot_bytes;
      }
      row(((size_t)b * g.H + r0 + i) * g.W, seg * kIm2colPx, src);
      // this warpgroup's next row reads from position i + wgs on
      release(i + wgs);
    }
    release(rows + 2);
    n += rows + 2;
  }
}

// Shared memory, from a 1024-byte aligned base: the barriers (the
// weights' full at 0, slot s's full at 8 + 8s and empty at
// 8 + 8 kIm2colMaxSlots + 8s), the weight slab at 1024 (row
// (tap nch + q) 64 + k holds the 64 weights of channel 64q + k of the tap
// to the block's output channels), the epilogue scratch (per consumer warp
// kIm2colOutPx pixels x kIm2colOutStride), then the slots (box q of a slot at
// q chunk_bytes).
template <bool ASYNC>
__global__ void __launch_bounds__(kIm2colThreads, 1)
conv_im2col_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap,
                        bf16* __restrict__ y, const Im2colGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t w_s = base + 1024, out_s = w_s + g.wts_bytes;
  const uint32_t ring = out_s + g.out_bytes;
  const int slots = ASYNC ? g.slots : 3;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int co0 = blockIdx.y * kIm2colCo;

  if (tid == 0) ring_init(base, slots, kIm2colWarpgroups);
  __syncthreads();

  if (warp == 4 * kIm2colWarpgroups) {
    // ------------------------------------------------------ producer
    if (lane == 0)
      im2col_produce(&xmap, &wmap, g, base, w_s, ring, slots, co0);
    return;
  }

  // -------------------------------------------------------- consumers
  const int wg = warp / 4, wl = warp % 4;
  // this warp's epilogue scratch, shared and generic addresses
  const uint32_t out_a = out_s + warp * kIm2colOutPx * kIm2colOutStride * 2;
  const bf16* out_w =
      reinterpret_cast<const bf16*>(smem + (out_a - smem_addr(smem)));
  mbar_wait(base, 0);
  im2col_consume(g, base, ring, slots, kIm2colWarpgroups, wg, lane,
                 [&](size_t rowpix, int c0, const uint32_t (&src)[3]) {
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    wgmma_fence();
    for (int q = 0; q < g.nch; ++q) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int du = tap / 3, dv = tap % 3;
        const uint32_t arow = w_s + (tap * g.nch + q) * 64 * 128;
        const uint32_t brow = src[du] + q * g.chunk_bytes + dv * 128;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_ss128(acc, wgmma_desc(arow + ks * 16 * 128, 16, 1024, 128),
                      wgmma_desc(brow + ks * 32, 16, 1024, 128));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    im2col_store_row(acc, y, rowpix, c0, co0, g.W, g.Cout, out_a, out_w, wl,
                     lane);
  });
}

// The tensor maps of x [B,H,W,C] (boxes of 64 channels x 130 pixels of
// one row, 128-byte swizzled) and w [9][C][Cout] (64 output channels x 64
// input channels of one tap, the same), zeros outside either; false where
// the CUDA driver refuses one.
inline bool im2col_maps(CUtensorMap* xmap, CUtensorMap* wmap, const void* x,
                        const void* w, int B, int H, int W, int C,
                        int Cout) {
  const cuuint64_t xdims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)B};
  const cuuint64_t xstr[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                              (cuuint64_t)H * W * C * 2};
  const cuuint32_t xbox[4] = {64, kIm2colPx + 2, 1, 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)Cout, (cuuint64_t)C, 9};
  const cuuint64_t wstr[2] = {(cuuint64_t)Cout * 2, (cuuint64_t)C * Cout * 2};
  const cuuint32_t wbox[3] = {kIm2colCo, 64, 1};
  return bf16_tile_map(xmap, x, 4, xdims, xstr, xbox, 128) &&
         bf16_tile_map(wmap, w, 3, wdims, wstr, wbox, 128);
}

// Launches the kernel for x [B,H,W,C] -> y [B,H,W,Cout]: both tensor maps
// are encoded per call (host work of a few microseconds).
// cudaErrorInvalidValue where the plan takes no slots or the CUDA driver
// refuses a map.
template <bool ASYNC>
int launch_im2col_sm90(const void* x, const void* w, void* y, int B, int H,
                       int W, int C, int Cout, cudaStream_t s) {
  const Im2colGeom g = im2col_geom(ASYNC, B, H, W, C, Cout, sm_count(),
                                   smem_optin_bytes());
  if (g.slots == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  if (!im2col_maps(&xmap, &wmap, x, w, B, H, W, C, Cout))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(g.grid, (Cout + kIm2colCo - 1) / kIm2colCo);
  return (int)launch_opted(conv_im2col_sm90_kernel<ASYNC>, grid,
                           kIm2colThreads, g.smem(g.slots), s, xmap, wmap,
                           (bf16*)y, g);
}

}  // namespace smsut
