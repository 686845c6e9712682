// Runs the kernels of smsut_tpu_torch/csrc/conv3x3_mma.cu (dots on
// conv3x3_dots_sm90.cuh where C <= 64 and its ring fits, else on the
// mma.sync kernel, each shape's route printed and checked; the im2col pair
// of conv3x3_im2col_sm90.cuh) on the CPU
// through the emulation of shim.h, prims.h and sm90_prims.h (TMA,
// mbarriers, wgmma, setmaxnreg), and holds every output
// against a float64 reference of the same bf16 inputs, rounded once to
// bf16: each output must be within one bf16 unit of it.  Outputs start as
// NaN, so an unwritten one fails.  A shape whose kernel does not fit the
// shared memory must be refused (rc != 0, fits 0).  Fails on any ldmatrix
// bank conflict, which the kernels' padded rows are meant to rule out.
//
// Environment: EMU_DEFER=1 lands cp.async copies at their wait; EMU_OPTIN
// sets the block's shared-memory limit in bytes; EMU_SMS the device's SMs
// (few: each im2col block walks several units, its ring wrapping).  Built and run by
// tests/test_torch_cuda_emu.py, which generates conv3x3_mma_emu.cpp.
#include <random>

#include "conv3x3_mma_emu.cpp"

using namespace smsut;

int main() {
  if (getenv("EMU_DEFER")) emu_defer = true;
  if (getenv("EMU_OPTIN")) emu_optin = atoi(getenv("EMU_OPTIN"));
  if (getenv("EMU_SMS")) emu_sms = atoi(getenv("EMU_SMS"));
  struct Shape { int B, H, W, C, Co, strip; };
  // W not a multiple of 16 (20, 130: more 16-pixel tiles than warps, 3);
  // Cout 16, 32, 48 and 128 (two blocks along Cout); C 16 to 64.  For the
  // im2col kernels' 64-pixel tiles: W 72 (a second, ragged tile for the
  // second warpgroup) and 200 (two column segments); C 128 (two 64-channel
  // boxes per row, too large for EMU_OPTIN=120000)
  const std::vector<Shape> shapes = {
      {2, 8, 20, 16, 16, 4},  {1, 8, 16, 32, 48, 8},  {1, 4, 16, 64, 64, 2},
      {1, 16, 24, 48, 32, 16}, {1, 4, 130, 16, 16, 2}, {1, 4, 16, 16, 128, 4},
      {1, 2, 3, 16, 32, 1},   {1, 3, 72, 32, 64, 1},  {1, 2, 200, 16, 32, 2},
      {1, 4, 16, 128, 64, 4}};
  std::mt19937 rng(1);
  std::normal_distribution<float> nd(0.f, 1.f);
  int failed = 0;
  for (const Shape& s : shapes) {
    const size_t nx = (size_t)s.B * s.H * s.W * s.C, nw = 9 * s.C * s.Co,
                 ny = (size_t)s.B * s.H * s.W * s.Co;
    std::vector<bf16> x(nx), w(nw);
    for (auto& v : x) v = __float2bfloat16(nd(rng));
    for (auto& v : w) v = __float2bfloat16(0.1f * nd(rng));
    std::vector<double> ref(ny, 0.0);
    for (int b = 0; b < s.B; ++b)
      for (int i = 0; i < s.H; ++i)
        for (int j = 0; j < s.W; ++j)
          for (int co = 0; co < s.Co; ++co) {
            double acc = 0;
            for (int u = 0; u < 3; ++u)
              for (int v = 0; v < 3; ++v) {
                const int ih = i + u - 1, iw = j + v - 1;
                if (ih < 0 || ih >= s.H || iw < 0 || iw >= s.W) continue;
                for (int ci = 0; ci < s.C; ++ci)
                  acc += (double)__bfloat162float(
                             x[((size_t)(b * s.H + ih) * s.W + iw) * s.C + ci]) *
                         __bfloat162float(w[((u * 3 + v) * s.C + ci) * s.Co + co]);
              }
            ref[((size_t)(b * s.H + i) * s.W + j) * s.Co + co] = acc;
          }
    const int route = smsut_conv3x3_dots_route(s.B, s.H, s.W, s.C, s.Co);
    for (int variant = 0; variant < 3; ++variant) {
      std::vector<bf16> y(ny, __nv_bfloat16{0x7fc0});
      // dots: on the Hopper kernel (route 2) where C <= 64 and its ring
      // fits, else on the mma.sync kernel (1) where that fits
      const int want_route =
          s.C <= 64 && dots_geom(1, 1, s.W, s.C, s.Co, 1, 0).smem(4) <=
                           (size_t)emu_optin
              ? 2
          : smem_bytes(0, s.W, s.C, s.Co) <= (size_t)emu_optin           ? 1
                                                                          : 0;
      const bool fits = variant == 0 ? want_route != 0
                                     : smem_bytes(variant, s.W, s.C, s.Co) <=
                                           (size_t)emu_optin;
      auto fn = variant == 0   ? smsut_conv3x3_dots
                : variant == 1 ? smsut_conv3x3_im2col
                               : smsut_conv3x3_im2col2;
      const int rc = fn(x.data(), w.data(), y.data(), s.B, s.H, s.W, s.C,
                        s.Co, s.strip, nullptr);
      double worst = 0;
      size_t bad = 0;
      if (fits) {
        for (size_t i = 0; i < ny; ++i) {
          const float got = __bfloat162float(y[i]);
          const float want = __bfloat162float(__float2bfloat16((float)ref[i]));
          const double ulp = std::max(std::fabs(want) / 128.0, 1e-6);
          const double e = std::fabs(got - want) / ulp;
          if (!(e <= 1.0)) ++bad;
          if (!(e <= worst)) worst = e;
        }
      }
      const bool ok = (fits ? rc == 0 && bad == 0 : rc != 0) &&
                      (variant != 0 || route == want_route);
      printf("B%d H%d W%d C%d Cout%d strip%d variant %d: fits %d rc %d, "
             "worst %.3g bf16 units, %zu outside one unit", s.B, s.H, s.W,
             s.C, s.Co, s.strip, variant, fits, rc, worst, bad);
      if (variant == 0) printf(", route %d", route);
      printf(": %s\n", ok ? "ok" : "FAILED");
      failed += !ok;
    }
  }
  const long conflicts = emu_conflicts.load();
  printf("wgmma %ld, TMA loads %ld, maps refused %d, setmaxnreg %ld\n",
         emu_wgmma.load(), emu_tma_loads.load(), emu_encode_errors,
         emu_setmaxnreg_calls.load());
  printf("ldmatrix %ld, bank-conflicted phases %ld\n", emu_ldmatrix.load(),
         conflicts);
  printf("%s\n", failed || conflicts ? "FAIL" : "OK");
  return failed || conflicts ? 1 : 0;
}
