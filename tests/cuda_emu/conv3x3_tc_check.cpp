// Runs K2's tensor-core kernel (smsut_tpu_torch/csrc/conv3x3_tc.cuh) on the
// CPU through the emulation of shim.h and prims.h, at every block shape of
// the widest NCO that divides each case's Cout, and holds every output
// against a float64 reference of the same bf16 inputs, rounded once to
// bf16: each output must be within one bf16 unit of it.  Outputs start as
// NaN, so an unwritten one fails.  A block shape that no channel chunk fits
// into the shared memory must be refused (rc != 0, fits 0).  Fails on any
// ldmatrix bank conflict.
//
// The cases cover Cin 8 (padded to one k16 step) and Cout 8 (the
// ldmatrix.x2 B fragment), Cin % 8 != 0 (element loads), W 16 and 20, H not
// a multiple of the band, batch 2, more than one block along Cout, and
// Cin 48 and 64, which a small EMU_OPTIN cuts into channel chunks (odd and
// even in number).
//
// Environment: EMU_DEFER=1 lands cp.async copies at their wait; EMU_OPTIN
// sets the block's shared-memory limit in bytes.  Built and run by
// tests/test_torch_cuda_emu.py, which generates conv3x3_tc_emu.cuh.
#include <random>

#include "conv3x3_tc_emu.cuh"

using namespace smsut;

int main() {
  if (getenv("EMU_DEFER")) emu_defer = true;
  if (getenv("EMU_OPTIN")) emu_optin = atoi(getenv("EMU_OPTIN"));
  struct Shape { int B, H, W, C, Co; };
  const std::vector<Shape> shapes = {
      {1, 5, 16, 8, 16},  {2, 3, 20, 16, 8},  {1, 4, 20, 12, 16},
      {1, 4, 16, 64, 32}, {1, 3, 16, 48, 16}, {1, 4, 16, 32, 64},
      {1, 2, 16, 16, 24}};
  std::mt19937 rng(1);
  std::normal_distribution<float> nd(0.f, 1.f);
  int failed = 0, chunked = 0;
  for (const Shape& s : shapes) {
    const size_t nx = (size_t)s.B * s.H * s.W * s.C, nw = 9 * s.C * s.Co,
                 ny = (size_t)s.B * s.H * s.W * s.Co;
    // x with one spare element in front, so that a Cin % 8 != 0 case also
    // sees an x that is not 16-byte aligned
    std::vector<bf16> xbuf(nx + 8), w(nw);
    bf16* x = xbuf.data() + (s.C % 8 ? 1 : 0);
    for (size_t i = 0; i < nx; ++i) x[i] = __float2bfloat16(nd(rng));
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
    const int nco = s.Co % 64 == 0 ? 64 : s.Co % 32 == 0 ? 32
                    : s.Co % 16 == 0 ? 16 : 8;
    for (int cfg = 0; cfg < kTcFwdNCfgs; ++cfg) {
      if (kTcFwdCfgs[cfg].nco != nco) continue;
      std::vector<bf16> y(ny, __nv_bfloat16{0x7fc0});
      TcFwdPlan p{};
      const bool fits = tc_fwd_plan(s.B, s.H, s.W, s.C, s.Co,
                                    (size_t)emu_optin, cfg, &p);
      chunked += fits && p.nchunks > 1;
      const int rc = conv3x3_tc(x, w.data(), y.data(), s.B, s.H, s.W, s.C,
                                s.Co, nullptr, cfg);
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
      const bool ok = fits ? rc == 0 && bad == 0 : rc != 0;
      printf("B%d H%d W%d C%d Cout%d cfg %d (NCO %d TH %d): fits %d KC %d "
             "chunks %d rc %d, worst %.3g bf16 units, %zu outside one "
             "unit: %s\n",
             s.B, s.H, s.W, s.C, s.Co, cfg, nco, tc_fwd_th(kTcFwdCfgs[cfg]),
             fits, p.KC, p.nchunks, rc, worst, bad, ok ? "ok" : "FAILED");
      failed += !ok;
    }
  }
  const long conflicts = emu_conflicts.load();
  printf("chunked runs %d\n", chunked);
  printf("ldmatrix %ld, bank-conflicted phases %ld\n", emu_ldmatrix.load(),
         conflicts);
  printf("%s\n", failed || conflicts ? "FAIL" : "OK");
  return failed || conflicts ? 1 : 0;
}
