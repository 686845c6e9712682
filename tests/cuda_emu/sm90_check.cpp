// Unit cases of the Hopper primitives' emulation (sm90_prims.h) together
// with the helpers of smsut_tpu_torch/csrc/sm90.cuh that the kernels use
// as they are (wgmma_desc, bf16_tile_map), each
// held against a dense reference written here from the PTX ISA's words:
//
//   mbarrier   phases of a barrier all threads arrive on, a producer and
//              127 consumers taking turns on a full/empty pair, a wait on
//              the phase before a fresh barrier's first (it passes);
//   tma        3- and 4-dimensional boxes at negative and past-the-end
//              coordinates and wider than the tensor, swizzled by 0, 32,
//              64 and 128 bytes (16-byte chunk c of 128-byte row r lands at
//              chunk c ^ (r mod S/16)), poisoned until their barrier
//              completes; the maps the CUDA driver refuses;
//   wgmma      m64nNk16 (N 16, 32, 64) with A from registers and B landed
//              by TMA and read through descriptors, two k16 steps in two
//              groups: the accumulators read NaN before the wait_group that
//              retires their last group, then A B within float32 rounding;
//              m64n128k16 with A transposed and B K-major, both landed by
//              TMA, B read from a start one swizzle row and 32 bytes into
//              the pattern (the conv kernels' tap shift and k16 step); and
//              m64n128k16 with A from registers and the same B;
//   setmaxnreg a producer warpgroup lowered to 24 registers and two
//              consumer warpgroups raised to 240, as the conv kernels do;
//   deadlock   a wait on a phase nobody completes: must fail (exit 5);
//   unfenced   a wgmma without wgmma.fence before it: must fail (exit 5);
//   nreg_warp  a setmaxnreg that one warp of the warpgroup skips: must
//              fail (exit 5);
//   nreg_unpaid a setmaxnreg.inc that no dec frees registers for: must
//              fail (exit 5).
//
// Usage: sm90_check <case>; prints OK on success.  Built and run by
// tests/test_torch_cuda_emu.py, which generates sm90_emu.cuh.
#include <random>

#include "sm90_emu.cuh"

using namespace smsut;

static int failures = 0;
#define CHECK(cond, ...)                \
  do {                                  \
    if (!(cond)) {                      \
      printf("FAILED: " __VA_ARGS__);   \
      printf("\n");                     \
      ++failures;                       \
    }                                   \
  } while (0)

static uint16_t bits(float f) { return __float2bfloat16(f).x; }
static float val(uint16_t b) { return __bfloat162float(__nv_bfloat16{b}); }

// ------------------------------------------------------------ mbarrier
__global__ void mbar_kernel(int* bad) {
  const int tid = threadIdx.x;
  const uint32_t A = 0, F = 8, E = 16, FRESH = 24;
  int* data = reinterpret_cast<int*>(emu_smem + 1024);
  int* msg = data + 256;
  if (tid == 0) {
    mbar_init(A, 128);
    mbar_init(F, 1);
    mbar_init(E, 127);
    mbar_init(FRESH, 5);
    mbar_fence_init();
  }
  __syncthreads();
  // the phase before a fresh barrier's first has parity 1: complete
  mbar_wait(FRESH, 1);
  for (int p = 0; p < 4; ++p) {
    data[128 * (p & 1) + tid] = tid * 10 + p;
    mbar_arrive(A);
    mbar_wait(A, p & 1);
    long s = 0;
    for (int i = 0; i < 128; ++i) s += data[128 * (p & 1) + i];
    if (s != 10L * 127 * 128 / 2 + 128L * p) bad[tid] = 1;
  }
  for (int r = 0; r < 5; ++r) {
    if (tid == 0) {
      if (r > 0) mbar_wait(E, (r - 1) & 1);
      for (int i = 0; i < 64; ++i) msg[i] = 1000 * r + i;
      mbar_arrive(F);
    } else {
      mbar_wait(F, r & 1);
      if (msg[tid % 64] != 1000 * r + tid % 64) bad[tid] = 2;
      mbar_arrive(E);
    }
  }
}

static void case_mbarrier() {
  std::vector<int> bad(128, 0);
  emu_launch(mbar_kernel, dim3(2), 128, 4096, nullptr, bad.data());
  for (int t = 0; t < 128; ++t) CHECK(bad[t] == 0, "thread %d: %d", t, bad[t]);
  printf("mbarrier: 2 blocks of 128 threads, %ld waits\n",
         emu_mbar_waits.load());
}

// ------------------------------------------------------------------ TMA
// thread 0 loads the box into shared memory at 1024; thread 1 reads the
// first 16 bytes before any wait (poison); then all wait and the box's
// bytes are copied out
__global__ void tma_kernel(CUtensorMap map, int rank, int c0, int c1, int c2,
                           int c3, uint32_t bytes, unsigned char* out,
                           int* poisoned) {
  const uint32_t F = 0, dst = 1024;
  if (threadIdx.x == 0) {
    mbar_init(F, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(F, bytes);
    if (rank == 3)
      tma_load_3d(dst, &map, F, c0, c1, c2);
    else
      tma_load_4d(dst, &map, F, c0, c1, c2, c3);
  }
  __syncthreads();
  if (threadIdx.x == 1) {
    bool all = true;
    for (int i = 0; i < 16; ++i) all = all && emu_smem[dst + i] == 0xFF;
    *poisoned = all;
  }
  __syncthreads();
  mbar_wait(F, 0);
  for (uint32_t i = threadIdx.x; i < bytes; i += blockDim.x)
    out[i] = emu_smem[dst + i];
}

static void case_tma() {
  std::mt19937 rng(7);
  std::normal_distribution<float> nd(0.f, 1.f);
  int cases = 0;
  for (int S : {0, 32, 64, 128}) {
    const int inner = S ? S / 2 : 24;   // box inner elements: S bytes
    for (int narrow = 0; narrow < 2; ++narrow) {
      // the tensor: [B=2][H=5][W=10][C], C the box's inner width or 8
      const int C = narrow ? 8 : inner, W = 10, H = 5, B = 2;
      std::vector<uint16_t> T((size_t)B * H * W * C);
      for (auto& v : T) v = bits(nd(rng));
      for (int rank : {3, 4}) {
        const cuuint64_t dims4[4] = {(cuuint64_t)C, (cuuint64_t)W,
                                     (cuuint64_t)H, (cuuint64_t)B};
        const cuuint64_t dims3[3] = {(cuuint64_t)C, (cuuint64_t)W,
                                     (cuuint64_t)H * B};
        const cuuint64_t str[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                   (cuuint64_t)H * W * C * 2};
        const cuuint32_t box[4] = {(cuuint32_t)inner, 12, 3, 1};
        CUtensorMap map;
        const bool ok = bf16_tile_map(&map, T.data(), rank,
                                      rank == 4 ? dims4 : dims3, str, box, S);
        CHECK(ok, "encode S %d rank %d C %d", S, rank, C);
        if (!ok) continue;
        // at the origin's corner, inside, and past the end
        const int origins[3][4] = {{0, -1, -1, 0}, {0, 0, 1, 1},
                                   {0, 5, 3, 1}};
        for (const auto& o : origins) {
          const uint32_t bytes = (uint32_t)inner * 12 * 3 * 2;
          std::vector<unsigned char> out(bytes);
          int poisoned = 0;
          emu_launch(tma_kernel, dim3(1), 64, 1024 + bytes, nullptr, map,
                     rank, o[0], o[1], rank == 4 ? o[2] : o[2] + H * o[3],
                     o[3], bytes, out.data(), &poisoned);
          CHECK(poisoned, "S %d rank %d: the box was not poisoned", S, rank);
          for (uint32_t e = 0; e < bytes / 2; ++e) {
            const int i0 = e % inner, i1 = e / inner % 12, i2 = e / inner / 12;
            const int c = o[0] + i0, w = o[1] + i1;
            // rank 3 folds (H, B) into one dimension at o[2] + H * o[3]
            const int hb = rank == 4 ? o[2] + i2 : o[2] + H * o[3] + i2;
            const int h = rank == 4 ? hb : hb % H, b = rank == 4 ? o[3] : hb / H;
            const bool in = c >= 0 && c < C && w >= 0 && w < W &&
                            (rank == 4 ? hb >= 0 && hb < H : hb >= 0 && hb < H * B);
            const uint16_t want =
                in ? T[(((size_t)b * H + h) * W + w) * C + c] : 0;
            const uint32_t L = 1024 + 2 * e, row = L / 128,
                           chunk = L % 128 / 16;
            const uint32_t phys =
                S ? row * 128 + (chunk ^ (row % (S / 16))) * 16 + L % 16 : L;
            uint16_t got;
            memcpy(&got, &out[phys - 1024], 2);
            if (got != want) {
              CHECK(false, "S %d rank %d C %d origin (%d,%d,%d,%d) elem %u: "
                    "%04x != %04x", S, rank, C, o[0], o[1], o[2], o[3], e,
                    got, want);
              break;
            }
          }
          ++cases;
        }
      }
    }
  }
  // maps the CUDA driver refuses
  std::vector<uint16_t> T(4096);
  const cuuint64_t dims[3] = {64, 8, 8};
  const cuuint64_t str[2] = {128, 1024}, odd[2] = {120, 1024};
  const cuuint32_t box[3] = {64, 8, 1}, big[3] = {64, 257, 1},
                   narrow[3] = {32, 8, 1};
  CUtensorMap map;
  CHECK(!bf16_tile_map(&map, T.data() + 1, 3, dims, str, box, 128),
        "an address not 16-byte aligned was taken");
  CHECK(!bf16_tile_map(&map, T.data(), 3, dims, odd, box, 128),
        "a stride not a multiple of 16 was taken");
  CHECK(!bf16_tile_map(&map, T.data(), 3, dims, str, big, 128),
        "a box over 256 was taken");
  CHECK(!bf16_tile_map(&map, T.data(), 3, dims, str, box, 64),
        "a box wider than its swizzle was taken");
  CHECK(!bf16_tile_map(&map, T.data(), 3, dims, str, narrow, 128),
        "a box narrower than its swizzle was taken (not emulated)");
  printf("tma: %d boxes, %ld loads\n", cases, emu_tma_loads.load());
}

// ---------------------------------------------------------------- wgmma
// A [64][32] from registers, B [32][N] landed by TMA with a swizzle of 2N
// bytes; two groups of one k16 step each
template <int N>
__global__ void wgmma_kernel(CUtensorMap bmap, const uint16_t* A, float* out,
                             int* nan_before) {
  constexpr int SB = 2 * N;
  const uint32_t F = 0, b_s = 1024;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane / 4, t = lane % 4;
  if (tid == 0) {
    mbar_init(F, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(F, 32 * SB);
    tma_load_3d(b_s, &bmap, F, 0, 0, 0);
  }
  mbar_wait(F, 0);
  auto pack = [&](int row, int k) {
    return (uint32_t)A[row * 32 + k] | (uint32_t)A[row * 32 + k + 1] << 16;
  };
  uint32_t a[2][4];
  for (int ks = 0; ks < 2; ++ks) {
    const int r = 16 * w + g, k = 16 * ks + 2 * t;
    a[ks][0] = pack(r, k);
    a[ks][1] = pack(r + 8, k);
    a[ks][2] = pack(r, k + 8);
    a[ks][3] = pack(r + 8, k + 8);
  }
  float acc[N / 2];
  for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;
  for (int ks = 0; ks < 2; ++ks) {
    wgmma_fence();
    wgmma_rs<N>(acc, a[ks], wgmma_desc(b_s + 16 * ks * SB, 8 * SB, 8 * SB, SB));
    wgmma_commit();
  }
  bool nan = std::isnan(acc[0]);
  wgmma_wait<1>();   // the second group still uses acc
  nan = nan && std::isnan(acc[N / 2 - 1]);
  wgmma_wait<0>();
  nan_before[tid] = nan;
  for (int j = 0; j < N / 8; ++j)
    for (int h = 0; h < 2; ++h)
      for (int e = 0; e < 2; ++e)
        out[(16 * w + g + 8 * h) * N + 8 * j + 2 * t + e] =
            acc[4 * j + 2 * h + e];
}

template <int N> static void wgmma_case(std::mt19937& rng) {
  std::normal_distribution<float> nd(0.f, 1.f);
  std::vector<uint16_t> A(64 * 32), Bm(32 * N);
  for (auto& v : A) v = bits(nd(rng));
  for (auto& v : Bm) v = bits(nd(rng));
  const cuuint64_t dims[3] = {N, 32, 1};
  const cuuint64_t str[2] = {N * 2, 32 * N * 2};
  const cuuint32_t box[3] = {N, 32, 1};
  CUtensorMap map;
  CHECK(bf16_tile_map(&map, Bm.data(), 3, dims, str, box, 2 * N),
        "encode B, N %d", N);
  std::vector<float> out(64 * N, -1.f);
  std::vector<int> nan(128, 0);
  emu_launch(wgmma_kernel<N>, dim3(1), 128, 1024 + 32 * 2 * N, nullptr, map,
             A.data(), out.data(), nan.data());
  for (int t = 0; t < 128; ++t)
    CHECK(nan[t], "N %d thread %d: accumulators readable before the wait",
          N, t);
  double worst = 0;
  for (int i = 0; i < 64; ++i)
    for (int n = 0; n < N; ++n) {
      double ref = 0, mag = 0;
      for (int k = 0; k < 32; ++k) {
        const double p = (double)val(A[i * 32 + k]) * val(Bm[k * N + n]);
        ref += p;
        mag += std::fabs(p);
      }
      worst = std::max(worst, std::fabs(out[i * N + n] - ref) / (mag + 1e-30));
    }
  CHECK(worst <= 1e-6, "N %d: worst error %.3g of sum |a b|", N, worst);
  printf("wgmma N %d: worst %.3g of sum |a b|\n", N, worst);
}

// m64n128k16 with both operands landed by TMA, 128-byte swizzled: A =
// At [32 k][64 m] read transposed, B = X [130 px][64 ch] read K-major from
// one pixel on (a start a swizzle row into the pattern) and, in the second
// k16 step, 32 bytes into each row
__global__ void wgmma_ss_kernel(CUtensorMap amap, CUtensorMap bmap,
                                float* out, int* nan_before) {
  const uint32_t F = 0, a_s = 1024, b_s = 1024 + 32 * 128;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane / 4, t = lane % 4;
  if (tid == 0) {
    mbar_init(F, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(F, (32 + 130) * 128);
    tma_load_3d(a_s, &amap, F, 0, 0, 0);
    tma_load_3d(b_s, &bmap, F, 0, 0, 0);
  }
  mbar_wait(F, 0);
  float acc[64];
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  wgmma_fence();
  for (int ks = 0; ks < 2; ++ks)
    wgmma_ss128(acc, wgmma_desc(a_s + 16 * ks * 128, 16, 1024, 128),
                wgmma_desc(b_s + 128 + 32 * ks, 16, 1024, 128));
  wgmma_commit();
  bool nan = std::isnan(acc[0]) && std::isnan(acc[63]);
  wgmma_wait<0>();
  nan_before[tid] = nan;
  for (int j = 0; j < 16; ++j)
    for (int h = 0; h < 2; ++h)
      for (int e = 0; e < 2; ++e)
        out[(16 * w + g + 8 * h) * 128 + 8 * j + 2 * t + e] =
            acc[4 * j + 2 * h + e];
}

static void wgmma_ss_case(std::mt19937& rng) {
  std::normal_distribution<float> nd(0.f, 1.f);
  std::vector<uint16_t> At(32 * 64), X(130 * 64);
  for (auto& v : At) v = bits(nd(rng));
  for (auto& v : X) v = bits(nd(rng));
  const cuuint64_t adims[3] = {64, 32, 1}, bdims[3] = {64, 130, 1};
  const cuuint64_t astr[2] = {128, 32 * 128}, bstr[2] = {128, 130 * 128};
  const cuuint32_t abox[3] = {64, 32, 1}, bbox[3] = {64, 130, 1};
  CUtensorMap amap, bmap;
  CHECK(bf16_tile_map(&amap, At.data(), 3, adims, astr, abox, 128) &&
            bf16_tile_map(&bmap, X.data(), 3, bdims, bstr, bbox, 128),
        "encode the SS operands");
  std::vector<float> out(64 * 128, -1.f);
  std::vector<int> nan(128, 0);
  emu_launch(wgmma_ss_kernel, dim3(1), 128, 1024 + (32 + 130) * 128 + 1024,
             nullptr, amap, bmap, out.data(), nan.data());
  for (int t = 0; t < 128; ++t)
    CHECK(nan[t], "SS thread %d: accumulators readable before the wait", t);
  double worst = 0;
  for (int m = 0; m < 64; ++m)
    for (int px = 0; px < 128; ++px) {
      double ref = 0, mag = 0;
      for (int k = 0; k < 32; ++k) {
        const double p = (double)val(At[k * 64 + m]) * val(X[(px + 1) * 64 + k]);
        ref += p;
        mag += std::fabs(p);
      }
      worst = std::max(worst, std::fabs(out[m * 128 + px] - ref) / (mag + 1e-30));
    }
  CHECK(worst <= 1e-6, "SS: worst error %.3g of sum |a b|", worst);
  printf("wgmma m64n128k16 SS: worst %.3g of sum |a b|\n", worst);
}

// m64n128k16 with A [64][32] from registers (each warp's fragments, as
// wgmma_kernel packs them) and B = X [130 px][64 ch] K-major as in
// wgmma_ss_kernel: from one pixel on, and 32 bytes into each row for the
// second k16 step; one group of two
__global__ void wgmma_rs128_kernel(CUtensorMap bmap, const uint16_t* A,
                                   float* out, int* nan_before) {
  const uint32_t F = 0, b_s = 1024;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane / 4, t = lane % 4;
  if (tid == 0) {
    mbar_init(F, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(F, 130 * 128);
    tma_load_3d(b_s, &bmap, F, 0, 0, 0);
  }
  mbar_wait(F, 0);
  auto pack = [&](int row, int k) {
    return (uint32_t)A[row * 32 + k] | (uint32_t)A[row * 32 + k + 1] << 16;
  };
  uint32_t a[2][4];
  for (int ks = 0; ks < 2; ++ks) {
    const int r = 16 * w + g, k = 16 * ks + 2 * t;
    a[ks][0] = pack(r, k);
    a[ks][1] = pack(r + 8, k);
    a[ks][2] = pack(r, k + 8);
    a[ks][3] = pack(r + 8, k + 8);
  }
  float acc[64];
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  wgmma_fence();
  for (int ks = 0; ks < 2; ++ks)
    wgmma_rs128(acc, a[ks], wgmma_desc(b_s + 128 + 32 * ks, 16, 1024, 128));
  wgmma_commit();
  bool nan = std::isnan(acc[0]) && std::isnan(acc[63]);
  wgmma_wait<0>();
  nan_before[tid] = nan;
  for (int j = 0; j < 16; ++j)
    for (int h = 0; h < 2; ++h)
      for (int e = 0; e < 2; ++e)
        out[(16 * w + g + 8 * h) * 128 + 8 * j + 2 * t + e] =
            acc[4 * j + 2 * h + e];
}

static void wgmma_rs128_case(std::mt19937& rng) {
  std::normal_distribution<float> nd(0.f, 1.f);
  std::vector<uint16_t> A(64 * 32), X(130 * 64);
  for (auto& v : A) v = bits(nd(rng));
  for (auto& v : X) v = bits(nd(rng));
  const cuuint64_t dims[3] = {64, 130, 1};
  const cuuint64_t str[2] = {128, 130 * 128};
  const cuuint32_t box[3] = {64, 130, 1};
  CUtensorMap map;
  CHECK(bf16_tile_map(&map, X.data(), 3, dims, str, box, 128),
        "encode the RS128 B");
  std::vector<float> out(64 * 128, -1.f);
  std::vector<int> nan(128, 0);
  emu_launch(wgmma_rs128_kernel, dim3(1), 128, 1024 + 130 * 128 + 1024,
             nullptr, map, A.data(), out.data(), nan.data());
  for (int t = 0; t < 128; ++t)
    CHECK(nan[t], "RS128 thread %d: accumulators readable before the wait",
          t);
  double worst = 0;
  for (int m = 0; m < 64; ++m)
    for (int px = 0; px < 128; ++px) {
      double ref = 0, mag = 0;
      for (int k = 0; k < 32; ++k) {
        const double p = (double)val(A[m * 32 + k]) * val(X[(px + 1) * 64 + k]);
        ref += p;
        mag += std::fabs(p);
      }
      worst = std::max(worst, std::fabs(out[m * 128 + px] - ref) / (mag + 1e-30));
    }
  CHECK(worst <= 1e-6, "RS128: worst error %.3g of sum |a b|", worst);
  printf("wgmma m64n128k16 RS: worst %.3g of sum |a b|\n", worst);
}

static void case_wgmma() {
  std::mt19937 rng(11);
  wgmma_case<16>(rng);
  wgmma_case<32>(rng);
  wgmma_case<64>(rng);
  wgmma_ss_case(rng);
  wgmma_rs128_case(rng);
  printf("wgmma: %ld issued\n", emu_wgmma.load());
}

// ----------------------------------------------------------- setmaxnreg
// 384 threads: warpgroup 2 lowers itself to 24 registers and ends,
// warpgroups 0 and 1 raise themselves to 240 (128 24 + 256 240 = 64512,
// the 168 a thread of the launch had) and record that they got there
__global__ void nreg_kernel(int* done) {
  if (threadIdx.x >= 256) {
    setmaxnreg_dec<24>();
    return;
  }
  setmaxnreg_inc<240>();
  done[threadIdx.x] = 1;
}

static void case_setmaxnreg() {
  std::vector<int> done(256, 0);
  emu_launch(nreg_kernel, dim3(2), 384, 0, nullptr, done.data());
  for (int t = 0; t < 256; ++t) CHECK(done[t], "thread %d did not finish", t);
  CHECK(emu_setmaxnreg_calls.load() == 2 * 384, "%ld setmaxnreg",
        emu_setmaxnreg_calls.load());
  printf("setmaxnreg: 2 blocks of 384 threads, %ld issued\n",
         emu_setmaxnreg_calls.load());
}

// --------------------------------------------------- misuse, must fail
__global__ void deadlock_kernel() {
  if (threadIdx.x == 0) mbar_init(0, 2);
  __syncthreads();
  if (threadIdx.x == 0) mbar_arrive(0);
  mbar_wait(0, 0);
}

__global__ void unfenced_kernel() {
  float acc[8] = {};
  const uint32_t a[4] = {0, 0, 0, 0};
  wgmma_rs<16>(acc, a, wgmma_desc(1024, 256, 256, 32));
  wgmma_commit();
  wgmma_wait<0>();
}

// warp 7 leaves its warpgroup's setmaxnreg to the other three
__global__ void nreg_warp_kernel() {
  if (threadIdx.x >= 128 && threadIdx.x < 224) setmaxnreg_dec<24>();
}

// an inc with no dec to pay for it
__global__ void nreg_unpaid_kernel() {
  if (threadIdx.x < 128) setmaxnreg_inc<240>();
}

int main(int argc, char** argv) {
  const std::string c = argc > 1 ? argv[1] : "";
  if (c == "mbarrier") case_mbarrier();
  else if (c == "tma") case_tma();
  else if (c == "wgmma") case_wgmma();
  else if (c == "setmaxnreg") case_setmaxnreg();
  else if (c == "nreg_warp") emu_launch(nreg_warp_kernel, dim3(1), 256, 0, nullptr);
  else if (c == "nreg_unpaid") emu_launch(nreg_unpaid_kernel, dim3(1), 384, 0, nullptr);
  else if (c == "deadlock") emu_launch(deadlock_kernel, dim3(1), 64, 0, nullptr);
  else if (c == "unfenced") emu_launch(unfenced_kernel, dim3(1), 128, 2048, nullptr);
  else {
    printf("unknown case %s\n", c.c_str());
    return 2;
  }
  printf("%s\n", failures ? "FAIL" : "OK");
  return failures ? 1 : 0;
}
