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
// With EMU_OPTS=1 it runs the options of the block chains instead (K3's
// and K6's convs), each at every block shape of its NCO, against a float64
// reference written here from their definitions:
// - STATS (KS 3 and 1, with and without PRO): every tile's partial sums of
//   y and y^2 over its pixels inside the map, within 1e-4 of the sums of
//   the terms' magnitudes (and their squares), partials starting as NaN;
// - PRO: x normalised and activated (v*g + h rounded per operation, leaky
//   ReLU, one rounding to bf16) at pixels inside the image only: the halo
//   stays 0, with h chosen so that lrelu(h) is far from it; C % 16 != 0,
//   element loads at C 12 (no (g, h) read past C: NaN lies there), and
//   channel chunks where EMU_OPTIN is small;
// - kEpiMask (y * lrelu'(norm_act(y1))) and kEpiAdd (+ a float32 map),
//   within one bf16 unit of the float64 value rounded once;
// - a float32 output at KS 1 (K6's shortcut term), within 1e-5 of the sum
//   of the terms' magnitudes;
// - the row window (K3's and K6's chains split over a space group): x of
//   hin rows, output row i reading input row i + u - 1 + off, rows outside
//   the input padding (zero, and left zero by PRO, with h far from 0): the
//   rows of both neighbours, the row below only and the row above only,
//   with STATS over the output rows alone, PRO, and the mask and add
//   epilogues.
//
// Environment: EMU_DEFER=1 lands cp.async copies at their wait; EMU_OPTIN
// sets the block's shared-memory limit in bytes; EMU_OPTS=1 runs the
// options.  Built and run by tests/test_torch_cuda_emu.py, which generates
// conv3x3_tc_emu.cuh.
#include <random>
#include <type_traits>

#include "conv3x3_tc_emu.cuh"

using namespace smsut;

namespace {

std::mt19937 rng(3);
std::normal_distribution<float> nd(0.f, 1.f);

float bf(bf16 v) { return __bfloat162float(v); }
template <typename T> T nan_of();
template <> float nan_of<float>() { return NAN; }
template <> bf16 nan_of<bf16>() { return __nv_bfloat16{0x7fc0}; }
float rbf(float v) { return bf(__float2bfloat16(v)); }
float lrelu_ref(float v) { return v >= 0.f ? v : 0.01f * v; }
// the activation as a stored bf16 value: v*g + h rounded per operation
float act_ref(float v, float g, float h) {
  const float p = v * g;
  return rbf(lrelu_ref(p + h));
}

std::vector<bf16> randbf(size_t n, float scale) {
  std::vector<bf16> v(n);
  for (auto& e : v) e = __float2bfloat16(scale * nd(rng));
  return v;
}
// per sample (g, h) [B][2][C]: g about 1, h about `hmean`
std::vector<float> gh_ref(int B, int C, float hmean) {
  std::vector<float> v((size_t)B * 2 * C);
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < C; ++c) {
      v[(size_t)b * 2 * C + c] = 1.f + 0.3f * nd(rng);
      v[(size_t)b * 2 * C + C + c] = hmean + 0.5f * nd(rng);
    }
  return v;
}

// H is the output's rows; with a window x holds hin rows at offset off
struct Shape { int B, H, W, C, Co, hin = 0, off = 0; };

// One option set at every block shape of the NCO of s.Co.
template <int KS, typename OutT, bool STATS, bool PRO, int EPI,
          bool WIN = false>
int run_case(const char* what, const Shape& s) {
  constexpr int R = KS / 2;
  const int HI = WIN ? s.hin : s.H, OFF = WIN ? s.off : 0;
  const size_t nx = (size_t)s.B * HI * s.W * s.C,
               ny = (size_t)s.B * s.H * s.W * s.Co;
  std::vector<bf16> x = randbf(nx, 1.f);
  std::vector<bf16> w = randbf((size_t)KS * KS * s.C * s.Co, 0.1f);
  std::vector<float> pgh = gh_ref(s.B, s.C, 0.8f);
  // NaN past the last sample's (g, h): PRO must read no (g, h) of a
  // channel past C (a NaN there would reach the output through the zero
  // weight rows)
  pgh.resize(pgh.size() + s.C, NAN);
  std::vector<float> egh = gh_ref(s.B, s.Co, 0.f);
  std::vector<bf16> ey = randbf(ny, 1.f);
  std::vector<float> ea(ny);
  for (auto& v : ea) v = nd(rng);
  // the conv's input as the kernel must see it
  std::vector<float> xin(nx);
  for (size_t i = 0; i < nx; ++i) {
    const int c = (int)(i % s.C), b = (int)(i / ((size_t)HI * s.W * s.C));
    const float* g = pgh.data() + (size_t)b * 2 * s.C;
    xin[i] = PRO ? act_ref(bf(x[i]), g[c], g[s.C + c]) : bf(x[i]);
  }
  std::vector<double> acc(ny, 0.0), mag(ny, 0.0);
  for (int b = 0; b < s.B; ++b)
    for (int i = 0; i < s.H; ++i)
      for (int j = 0; j < s.W; ++j)
        for (int co = 0; co < s.Co; ++co) {
          double a = 0, m = 0;
          for (int u = 0; u < KS; ++u)
            for (int v = 0; v < KS; ++v) {
              const int ih = i + u - R + OFF, iw = j + v - R;
              if (ih < 0 || ih >= HI || iw < 0 || iw >= s.W) continue;
              for (int ci = 0; ci < s.C; ++ci) {
                const double t =
                    (double)xin[((size_t)(b * HI + ih) * s.W + iw) * s.C + ci] *
                    bf(w[((u * KS + v) * s.C + ci) * s.Co + co]);
                a += t;
                m += std::fabs(t);
              }
            }
          const size_t o = ((size_t)(b * s.H + i) * s.W + j) * s.Co + co;
          acc[o] = a;
          mag[o] = m;
        }
  const int nco = s.Co % 64 == 0 ? 64 : s.Co % 32 == 0 ? 32
                  : s.Co % 16 == 0 ? 16 : 8;
  int failed = 0;
  for (int cfg = 0; cfg < kTcFwdNCfgs; ++cfg) {
    if (kTcFwdCfgs[cfg].nco != nco) continue;
    TcFwdPlan p{};
    const bool fits = tc_fwd_plan(s.B, s.H, s.W, s.C, s.Co,
                                  (size_t)emu_optin, cfg, &p, KS);
    const int th = tc_fwd_th(kTcFwdCfgs[cfg]);
    const int tw = (s.W + 15) / 16, nt = fits ? tc_fwd_ntiles(p, s.H, s.W) : 0;
    std::vector<OutT> y(ny, nan_of<OutT>());
    std::vector<float> part((size_t)s.B * (nt ? nt : 1) * 2 * s.Co, NAN);
    const TcOpts o{part.data(), pgh.data(),
                   EPI == kEpiAdd ? (const void*)ea.data() : ey.data(),
                   egh.data(), s.hin, s.off};
    const int rc = conv3x3_tc<KS, OutT, STATS, PRO, EPI, WIN>(
        x.data(), w.data(), y.data(), s.B, s.H, s.W, s.C, s.Co, nullptr, cfg,
        o);
    size_t bad = 0, bad_stats = 0;
    double worst = 0;
    for (size_t i = 0; fits && i < ny; ++i) {
      const int co = (int)(i % s.Co), b = (int)(i / ((size_t)s.H * s.W * s.Co));
      double want = acc[i];
      if (EPI == kEpiAdd) want += ea[i];
      if (EPI == kEpiMask) {
        const float* g = egh.data() + (size_t)b * 2 * s.Co;
        const float z = act_ref(bf(ey[i]), g[co], g[s.Co + co]);
        want *= z > 0.f ? 1.0 : 0.01;
      }
      double e;
      if constexpr (std::is_same<OutT, float>::value) {
        e = std::fabs(y[i] - want) / (1e-5 * mag[i] + 1e-30);
      } else {
        const float wb = rbf((float)want);
        e = std::fabs(bf(y[i]) - wb) / std::max(std::fabs(wb) / 128.0, 1e-6);
      }
      if (!(e <= 1.0)) ++bad;
      if (!(e <= worst)) worst = e;
    }
    if (STATS && fits) {
      for (int b = 0; b < s.B; ++b)
        for (int t = 0; t < nt; ++t)
          for (int co = 0; co < s.Co; ++co) {
            double s1 = 0, s2 = 0, m1 = 0, m2 = 0;
            for (int i = (t / tw) * th; i < std::min(s.H, (t / tw + 1) * th); ++i)
              for (int j = (t % tw) * 16; j < std::min(s.W, (t % tw) * 16 + 16); ++j) {
                const size_t o = ((size_t)(b * s.H + i) * s.W + j) * s.Co + co;
                s1 += acc[o];
                s2 += acc[o] * acc[o];
                m1 += mag[o];
                m2 += mag[o] * mag[o];
              }
            const float* q = part.data() + (((size_t)b * nt + t) * 2) * s.Co + co;
            if (!(std::fabs(q[0] - s1) <= 1e-4 * m1 + 1e-30) ||
                !(std::fabs(q[s.Co] - s2) <= 1e-4 * m2 + 1e-30))
              ++bad_stats;
          }
    }
    const bool ok = fits ? rc == 0 && bad == 0 && bad_stats == 0 : rc != 0;
    printf("%s B%d H%d W%d C%d Cout%d cfg %d (NCO %d TH %d): fits %d KC %d "
           "chunks %d rc %d, worst %.3g of the bound, %zu outputs and %zu "
           "partials over it: %s\n",
           what, s.B, s.H, s.W, s.C, s.Co, cfg, nco, th, fits, p.KC,
           p.nchunks, rc, worst, bad, bad_stats, ok ? "ok" : "FAILED");
    failed += !ok;
  }
  return failed;
}

int run_options() {
  int failed = 0;
  // K3: conv1, conv2 (norm 1 applied while staging) and the 1x1 shortcut,
  // each with its statistics
  for (Shape s : {Shape{2, 9, 20, 16, 16}, Shape{1, 5, 20, 24, 48},
                  Shape{1, 5, 20, 32, 64}})
    failed += run_case<3, bf16, true, false, kEpiNone>("stats", s);
  for (Shape s : {Shape{2, 9, 20, 16, 16}, Shape{1, 5, 20, 48, 48},
                  Shape{1, 6, 16, 32, 32}, Shape{1, 4, 16, 12, 16}})
    failed += run_case<3, bf16, true, true, kEpiNone>("stats+pro", s);
  for (Shape s : {Shape{2, 9, 20, 24, 16}, Shape{1, 4, 16, 12, 32}})
    failed += run_case<1, bf16, true, false, kEpiNone>("ks1+stats", s);
  // K6: dn1 masked by z1, dx plus the float32 side term, the side term
  for (Shape s : {Shape{2, 9, 20, 16, 16}, Shape{1, 5, 20, 32, 48}})
    failed += run_case<3, bf16, false, false, kEpiMask>("mask", s);
  for (Shape s : {Shape{2, 9, 20, 16, 8}, Shape{1, 5, 20, 48, 24}})
    failed += run_case<3, bf16, false, false, kEpiAdd>("add", s);
  for (Shape s : {Shape{2, 9, 20, 16, 8}, Shape{1, 4, 16, 32, 24}})
    failed += run_case<1, float, false, false, kEpiNone>("ks1+f32", s);
  // the row window: both neighbours' rows (conv1, dn1, dx), the row below
  // only and the row above only (conv2 at the image's top and bottom)
  for (Shape s : {Shape{2, 9, 20, 16, 16, 11, 1}, Shape{1, 5, 20, 48, 48, 7, 1}})
    failed += run_case<3, bf16, true, false, kEpiNone, true>("win+stats", s);
  for (Shape s : {Shape{2, 9, 20, 16, 16, 10, 0}, Shape{1, 6, 16, 32, 32, 7, 1},
                  Shape{1, 4, 16, 12, 16, 5, 0}})
    failed += run_case<3, bf16, true, true, kEpiNone, true>("win+stats+pro", s);
  for (Shape s : {Shape{2, 9, 20, 16, 16, 11, 1}})
    failed += run_case<3, bf16, false, false, kEpiMask, true>("win+mask", s);
  for (Shape s : {Shape{1, 5, 20, 48, 24, 7, 1}})
    failed += run_case<3, bf16, false, false, kEpiAdd, true>("win+add", s);
  return failed;
}

}  // namespace

int main() {
  if (getenv("EMU_DEFER")) emu_defer = true;
  if (getenv("EMU_OPTIN")) emu_optin = atoi(getenv("EMU_OPTIN"));
  if (getenv("EMU_OPTS")) {
    const int failed = run_options();
    const long conflicts = emu_conflicts.load();
    printf("ldmatrix %ld, bank-conflicted phases %ld\n", emu_ldmatrix.load(),
           conflicts);
    printf("%s\n", failed || conflicts ? "FAIL" : "OK");
    return failed || conflicts ? 1 : 0;
  }
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
