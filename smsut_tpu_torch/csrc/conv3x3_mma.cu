// Three 3x3 stride-1 SAME convolutions on the tensor cores, NHWC bfloat16
// in and out, HWIO bfloat16 weights, float32 accumulation and one rounding
// to bfloat16 at the store:
//
//   y[b,i,j,co] = sum_{u,v,ci} x[b, i+u-1, j+v-1, ci] * w[u,v,ci,co]
//
// They replace the three Pallas conv candidates of
// tools/microbench_pallas_conv.py, and differ as those do:
//   smsut_conv3x3_dots    `pallas_conv_dots` (:63, kernel `_dots_kernel`
//                         :44): nine accumulated tap products per pixel
//                         tile, from shifted views of the staged input;
//   smsut_conv3x3_im2col  `pallas_conv_im2col` (:99, `_im2col_kernel` :82):
//                         one K = 9C product per 64-pixel tile, the input
//                         copied and multiplied in turn;
//   smsut_conv3x3_im2col2 `pallas_conv_im2col2` (:139, `_im2col2_kernel`
//                         :120): the same with the next input's copy in
//                         flight while the products run.
// All three are Hopper kernels (TMA, mbarriers, wgmma, warp
// specialisation) where C <= 64: the im2col pair in
// conv3x3_im2col_sm90.cuh, dots in conv3x3_dots_sm90.cuh (its weights held
// in registers as wgmma's A).  dots takes C over 64 too, on the mma.sync
// kernel below (`dots_route`).
//
// Bound on the H100, at the tool's shape x [16,128,128,64], w [3,3,64,64]:
// 19.3 GFLOP, 0.0195 ms at 989 TF/s bf16; 67.2 MB moved (x and y 33.5 MB
// each, w 74 KB), 0.0201 ms at 3.35 TB/s.  Bytes bound it, by a hair: the
// conv does 288 operations per byte against the card's ~295.  To come near
// it a kernel must read x about once and keep the tensor cores busy.
// dots at C over 64 (and where the Hopper kernel's plan does not fit)
// runs the first, simple version, here:
//   - every product is a bf16 mma.sync.m16n8k16 with float32 accumulators
//     (mma_tile.cuh), its operands fed from shared memory by ldmatrix;
//   - one block of 256 threads walks a band of `strip` image rows of one
//     image (grid B*H/strip x Cout/NCO), and stages the block's weight
//     slab [9C][NCO] (73.7 KB at C = Cout = 64) in shared memory once;
//   - shared-memory rows are padded by 16 bytes (conflict-free ldmatrix);
//   - a ring of four halo'd input rows ((W+2) x C each, 18.7 KB at
//     W = 128, C = 64, padded), filled by cp.async one row ahead, with the
//     image border zero-filled while staging, so x is read about once.
//
// Shapes taken: C and Cout multiples of 16, H % strip == 0, 16-byte aligned
// x, w and y, and the block's shared memory within the device's limit
// (`takes`).  Anything else returns cudaErrorInvalidValue.
#include "mma_tile.cuh"
#include "conv3x3_im2col_sm90.cuh"
#include "conv3x3_dots_sm90.cuh"

using namespace smsut;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// w [9][C][Cout] -> w_s [9C][NCO + 8], output channels co0 .. co0+NCO-1
template <int NCO>
__device__ __forceinline__ void stage_weights(bf16* w_s,
                                              const bf16* __restrict__ w,
                                              int C, int Cout, int co0) {
  constexpr int CH = NCO / 8, NS = NCO + 8;
  const int n = 9 * C * CH;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int k = i / CH, c = i % CH;
    *reinterpret_cast<uint4*>(w_s + k * NS + c * 8) = __ldg(
        reinterpret_cast<const uint4*>(w + (size_t)k * Cout + co0 + c * 8));
  }
}

// The warp's 16 x 8NT float32 tile, rounded once, to output pixels
// pix0 + m (m < 16, pixel index of the row-major [H][W] map, masked by
// m < mmax) and channels y's co .. co + 8NT - 1.
template <int NT>
__device__ __forceinline__ void store_tile(bf16* __restrict__ y,
                                           const float (&acc)[NT][4],
                                           size_t pix0, int mmax, int Cout,
                                           int co, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = g + 8 * h;
    if (m < mmax) {
      bf16* p = y + (pix0 + m) * Cout + co + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        store_bf16x2(p + nt * 8, acc[nt][2 * h], acc[nt][2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------------ dots
// Ring slot s holds image row r (slot (r - r0 + 1) % 4) as W + 2 pixels of
// C + 8 elements, pixel 0 and W + 1 being the zero columns -1 and W.  At
// step `it` the block computes output row r0 + it from the slots of rows
// r0+it-1 .. r0+it+1 while cp.async fills row r0+it+2 into the fourth.
// Warp w takes the 16-pixel tiles w, w+8, .. of the row, all NCO channels:
// per tap and 16 channels one ldmatrix of A (the tap's shifted view) and
// NCO/16 of B.
template <int NCO>
__global__ void __launch_bounds__(kThreads, 1)
conv_dots_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 bf16* __restrict__ y, int H, int W, int C, int Cout,
                 int strip) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NT = NCO / 8, NS = NCO + 8;
  const int PS = C + 8, RS = (W + 2) * PS, cch = C / 8;
  bf16* w_s = reinterpret_cast<bf16*>(smem);
  bf16* ring = w_s + 9 * C * NS;
  const int bands = H / strip;
  const int b = blockIdx.x / bands, r0 = (blockIdx.x % bands) * strip;
  const int co0 = blockIdx.y * NCO;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* xb = x + (size_t)b * H * W * C;

  stage_weights<NCO>(w_s, w, C, Cout, co0);
  for (int i = tid; i < 4 * 2 * cch; i += kThreads) {
    const int s = i / (2 * cch), r = i % (2 * cch);
    *reinterpret_cast<uint4*>(ring + s * RS + (r / cch) * (W + 1) * PS +
                              (r % cch) * 8) = make_uint4(0, 0, 0, 0);
  }
  auto load_row = [&](int row, int s) {
    bf16* dst = ring + s * RS + PS;
    if (row >= 0 && row < H) {
      const bf16* src = xb + (size_t)row * W * C;
      for (int i = tid; i < W * cch; i += kThreads)
        cp_async16(smem_addr(dst + (i / cch) * PS + (i % cch) * 8),
                   src + (size_t)i * 8, true);
    } else {
      for (int i = tid; i < W * cch; i += kThreads)
        *reinterpret_cast<uint4*>(dst + (i / cch) * PS + (i % cch) * 8) =
            make_uint4(0, 0, 0, 0);
    }
  };
  load_row(r0 - 1, 0);
  load_row(r0, 1);
  load_row(r0 + 1, 2);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int nmt = (W + 15) / 16;
  const uint32_t bw = b_lane_addr(w_s, NS, lane);
  const int kq = C / 16;
  for (int it = 0; it < strip; ++it) {
    if (it + 1 < strip) {
      load_row(r0 + it + 2, (it + 3) & 3);
      cp_async_commit();
    }
    for (int mt = warp; mt < nmt; mt += kWarps) {
      float acc[NT][4] = {};
      // lanes past the row's end read its last pixel; their rows are
      // not stored
      const int p = min(mt * 16 + (lane & 15), W - 1);
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const bf16* slot = ring + ((it + u) & 3) * RS;
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          const uint32_t a = smem_addr(slot + (p + v) * PS + ((lane >> 4) << 3));
          const uint32_t bt = bw + (uint32_t)((u * 3 + v) * C * NS * 2);
          for (int kc = 0; kc < kq; ++kc)
            mma_k16<NT>(acc, a + kc * 32, bt + kc * 16 * NS * 2);
        }
      }
      store_tile<NT>(y, acc, ((size_t)b * H + r0 + it) * W + mt * 16,
                     W - mt * 16, Cout, co0, lane);
    }
    cp_async_wait<0>();
    __syncthreads();
  }
}

// ------------------------------------------------------------------ host
int nco_of(int Cout) {
  return Cout % 64 == 0 ? 64 : Cout % 32 == 0 ? 32 : 16;
}

// Dynamic shared memory of `variant` (0 dots, 1 im2col, 2 im2col2): the
// mma.sync dots kernel's weight slab and ring of four rows; the im2col
// kernels' plan at its least ring (im2col_geom: 3 slots, im2col2 4).
size_t smem_bytes(int variant, int W, int C, int Cout) {
  if (variant != 0)
    return im2col_geom(variant == 2, 1, 1, W, C, Cout, kSMs, 0)
        .smem(variant == 2 ? 4 : 3);
  return (size_t)9 * C * (nco_of(Cout) + 8) * sizeof(bf16) +
         (size_t)4 * (W + 2) * (C + 8) * sizeof(bf16);
}

bool shape_ok(int B, int H, int W, int C, int Cout) {
  return B >= 1 && H >= 1 && W >= 1 && C >= 16 && C % 16 == 0 &&
         Cout >= 16 && Cout % 16 == 0;
}

// The dots kernel a shape runs, decided by shape before any launch: 2 the
// Hopper kernel (C <= 64 and its plan fits the device's shared memory), 1
// the mma.sync kernel (its weight slab and ring fit), 0 neither (refused).
int dots_route(int B, int H, int W, int C, int Cout) {
  if (!shape_ok(B, H, W, C, Cout)) return 0;
  if (C <= 64 &&
      dots_geom(B, H, W, C, Cout, sm_count(), smem_optin_bytes()).slots > 0)
    return 2;
  return smem_bytes(0, W, C, Cout) <= smem_optin_bytes() ? 1 : 0;
}

// Everything the kernels need of a shape: C and Cout multiples of 16,
// H % strip == 0, 16-byte aligned x, w and y, and the block's shared
// memory within the device's limit (dots: a route).
bool takes(int variant, int B, int H, int W, int C, int Cout, int strip,
           const void* x, const void* w, const void* y) {
  return shape_ok(B, H, W, C, Cout) && strip >= 1 && H % strip == 0 &&
         (uintptr_t)x % 16 == 0 && (uintptr_t)w % 16 == 0 &&
         (uintptr_t)y % 16 == 0 &&
         (variant == 0 ? dots_route(B, H, W, C, Cout) != 0
                       : smem_bytes(variant, W, C, Cout) <=
                             smem_optin_bytes());
}

// The mma.sync dots kernel at NCO output channels per block, one block per
// band of `strip` rows.
template <int NCO>
int launch_dots(const void* x, const void* w, void* y, int B, int H, int W,
                int C, int Cout, int strip, cudaStream_t s) {
  const dim3 grid(B * (H / strip), Cout / NCO);
  return (int)launch_opted(conv_dots_kernel<NCO>, grid, kThreads,
                           smem_bytes(0, W, C, Cout), s, (const bf16*)x,
                           (const bf16*)w, (bf16*)y, H, W, C, Cout, strip);
}

// `variant` 0 dots, 1 im2col, 2 im2col2; the Hopper kernels pick their own
// bands (im2col_geom), whatever `strip`.
template <int V>
int entry(const void* x, const void* w, void* y, int B, int H, int W, int C,
          int Cout, int strip, void* stream) {
  if (!takes(V, B, H, W, C, Cout, strip, x, w, y))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (V != 0) {
    return launch_im2col_sm90<V == 2>(x, w, y, B, H, W, C, Cout, s);
  } else {
    if (dots_route(B, H, W, C, Cout) == 2)
      return launch_dots_sm90(x, w, y, B, H, W, C, Cout, s);
    switch (nco_of(Cout)) {
      case 64: return launch_dots<64>(x, w, y, B, H, W, C, Cout, strip, s);
      case 32: return launch_dots<32>(x, w, y, B, H, W, C, Cout, strip, s);
      default: return launch_dots<16>(x, w, y, B, H, W, C, Cout, strip, s);
    }
  }
}

}  // namespace

// x [B][H][W][C], w [3][3][C][Cout], y [B][H][W][Cout], all bfloat16.
// Each returns cudaErrorInvalidValue, launching nothing, for a shape the
// kernel does not take (`takes`), else the launch's cudaGetLastError().
extern "C" int smsut_conv3x3_dots(const void* x, const void* w, void* y,
                                  int B, int H, int W, int C, int Cout,
                                  int strip, void* stream) {
  return entry<0>(x, w, y, B, H, W, C, Cout, strip, stream);
}

// The kernel smsut_conv3x3_dots runs at a shape (whatever strip and
// alignment): 2 conv_dots_sm90_kernel, 1 conv_dots_kernel, 0 refused.
extern "C" int smsut_conv3x3_dots_route(int B, int H, int W, int C,
                                        int Cout) {
  return dots_route(B, H, W, C, Cout);
}

extern "C" int smsut_conv3x3_im2col(const void* x, const void* w, void* y,
                                    int B, int H, int W, int C, int Cout,
                                    int strip, void* stream) {
  return entry<1>(x, w, y, B, H, W, C, Cout, strip, stream);
}

extern "C" int smsut_conv3x3_im2col2(const void* x, const void* w, void* y,
                                     int B, int H, int W, int C, int Cout,
                                     int strip, void* stream) {
  return entry<2>(x, w, y, B, H, W, C, Cout, strip, stream);
}
