// K7 on Hopper: the dots conv candidate of tools/microbench_pallas_conv.py,
// `pallas_conv_dots` (:63, kernel `_dots_kernel` :44).  It computes
// y = 3x3 SAME conv, NHWC bf16 in and out, HWIO bf16 weights, float32
// accumulation and one rounding at the store, as the Pallas kernel does:
// nine accumulated tap products, each tap's weights the stationary
// operand.  Here that operand stays in registers.
//
// The design, on K9's plan and ring (conv3x3_im2col_sm90.cuh: units of
// (image, band of rows, 128-column segment) on a persistent grid, rows of
// 130 pixels x 64 channels by TMA, 128-byte swizzled, the border and the
// channels past C read as zeros, full/empty mbarrier pairs, the weights
// [9][64][64] by TMA once per block, the stmatrix epilogue):
//   - the product is taken transposed, y^T = W^T x^T, as
//     wgmma.m64n128k16 with M = 64 output channels and N = 128 pixels of
//     one image row, A (the weights) from registers and only B (the
//     pixels) read from shared memory through descriptors: 4 KB of
//     operands a wgmma where K9 reads 6 KB;
//   - each consumer warp loads its 16 output channels' fragments of all
//     nine taps x four k16 steps once, by ldmatrix.trans from the swizzled
//     slab (36 x 4 registers a thread, beside 64 of accumulator), so a
//     row is 36 wgmma of which each tap's column shift and k16 step move
//     only B's descriptor start (by 128 and 32 bytes);
//   - 384 threads: warpgroups 0-1 are consumers and take rows in turn
//     (row i to warpgroup i % 2), one's epilogue under the other's
//     products; warpgroup 2 is the producer, one lane issuing the TMA
//     loads.  The producer gives up its registers (setmaxnreg.dec to 24)
//     and the consumers take them (setmaxnreg.inc to 240: 128 24 +
//     256 240 = 64512 of the SM's 65536), in one if/else by role that
//     never reconverges, as ptxas needs to honour it;
//   - every row runs the box's four k16 steps, zero channels against zero
//     weight rows where C < 64, with no branch on C (a branch around the
//     wgmma made ptxas serialise them in K9's first build);
//   - no atomics, and `strip` changes neither grid nor math: two runs, and
//     any two strips, give the same bits.
// It takes C up to 64 (one box of channels, the 36 fragments of one
// 64-channel slab); the mma.sync kernel of conv3x3_mma.cu takes C over
// 64 (conv3x3_mma.cu `dots_route`).
#pragma once

#include "conv3x3_im2col_sm90.cuh"

namespace smsut {

constexpr int kDotsWarpgroups = 2;                       // consumers
constexpr int kDotsThreads = 128 * (kDotsWarpgroups + 1);
constexpr int kDotsProducerRegs = 24, kDotsConsumerRegs = 240;
static_assert(128 * kDotsProducerRegs +
                  128 * kDotsWarpgroups * kDotsConsumerRegs <= 65536,
              "the warpgroups' registers exceed the SM's");

// The plan: K9's ring (4 to kIm2colMaxSlots slots) for two consumer
// warpgroups; slots 0 where it does not fit `optin` bytes.
inline Im2colGeom dots_geom(int B, int H, int W, int C, int Cout, int sms,
                            size_t optin) {
  return im2col_geom(true, B, H, W, C, Cout, sms, optin, kDotsWarpgroups);
}

// Shared memory as in conv_im2col_sm90_kernel: the barriers at base, the
// weight slab at base + 1024 (row 64 tap + k holds the 64 weights of
// input channel k of the tap to the block's output channels), the
// epilogue scratch, then the slots.
__global__ void __launch_bounds__(kDotsThreads, 1)
conv_dots_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      bf16* __restrict__ y, const Im2colGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t w_s = base + 1024, out_s = w_s + g.wts_bytes;
  const uint32_t ring = out_s + g.out_bytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int co0 = blockIdx.y * kIm2colCo;

  if (tid == 0) ring_init(base, g.slots, kDotsWarpgroups);
  __syncthreads();

  if (warp >= 4 * kDotsWarpgroups) {
    // ------------------------------------------------------ producer
    setmaxnreg_dec<kDotsProducerRegs>();
    if (warp == 4 * kDotsWarpgroups && lane == 0)
      im2col_produce(&xmap, &wmap, g, base, w_s, ring, g.slots, co0);
  } else {
    // ----------------------------------------------------- consumers
    setmaxnreg_inc<kDotsConsumerRegs>();
    const int wg = warp / 4, wl = warp % 4;
    const uint32_t out_a =
        out_s + warp * kIm2colOutPx * kIm2colOutStride * 2;
    const bf16* out_w =
        reinterpret_cast<const bf16*>(smem + (out_a - smem_addr(smem)));
    // A = W^T: fragment 4 tap + ks holds output channels co0 + 16 wl ..
    // + 15 (rows) x input channels 16 ks .. + 15 (columns) of the tap.
    // The slab stores it transposed (a row per input channel), so
    // ldmatrix.trans: matrix m = lane / 8 of the x4 is the fragment's
    // register m (rows + 8 (m & 1), columns + 8 (m >> 1)), and lane gives
    // the address of slab row 8 (m >> 1) + lane % 8 of the k16 step, its
    // 16-byte chunk 2 wl + (m & 1) swizzled by the row's place (lane % 8).
    mbar_wait(base, 0);
    const int m = lane >> 3, r = lane & 7;
    const uint32_t alane =
        w_s + (8 * (m >> 1) + r) * 128 + (((2 * wl + (m & 1)) ^ r) << 4);
    uint32_t a[36][4];
#pragma unroll
    for (int f = 0; f < 36; ++f)
      ldmatrix_x4_trans(a[f], alane + (f >> 2) * 64 * 128 + (f & 3) * 16 * 128);
    im2col_consume(g, base, ring, g.slots, kDotsWarpgroups, wg, lane,
                   [&](size_t rowpix, int c0, const uint32_t (&src)[3]) {
      float acc[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t brow = src[tap / 3] + (tap % 3) * 128;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_rs128(acc, a[4 * tap + ks],
                      wgmma_desc(brow + ks * 32, 16, 1024, 128));
      }
      wgmma_commit();
      wgmma_wait<0>();
      im2col_store_row(acc, y, rowpix, c0, co0, g.W, g.Cout, out_a, out_w,
                       wl, lane);
    });
  }
}

// Launches the kernel for x [B,H,W,C] -> y [B,H,W,Cout], C <= 64.
// cudaErrorInvalidValue where C is over 64, the plan takes no slots or
// the CUDA driver refuses a map.
inline int launch_dots_sm90(const void* x, const void* w, void* y, int B,
                            int H, int W, int C, int Cout, cudaStream_t s) {
  const Im2colGeom g =
      dots_geom(B, H, W, C, Cout, sm_count(), smem_optin_bytes());
  CUtensorMap xmap, wmap;
  if (C > 64 || g.slots == 0 ||
      !im2col_maps(&xmap, &wmap, x, w, B, H, W, C, Cout))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(g.grid, (Cout + kIm2colCo - 1) / kIm2colCo);
  return (int)launch_opted(conv_dots_sm90_kernel, grid, kDotsThreads,
                           g.smem(g.slots), s, xmap, wmap, (bf16*)y, g);
}

}  // namespace smsut
