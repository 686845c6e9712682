// Runs K5's tensor-core kernel (smsut_tpu_torch/csrc/conv3x3_dw_tc.cuh) on
// the CPU through the emulation of shim.h and prims.h, and holds every
// element of dw against a float64 reference of the same bf16 inputs: it
// must be within 1e-5 of the sum of |x * g| over the terms of that element
// (float32 accumulation of exact bf16 products).  dw starts as NaN, so an
// unwritten element fails; the run is repeated and must agree bit for bit.
// Fails on any ldmatrix bank conflict.
//
// The cases cover Cin 8 (M padded to 16), Cin % 8 != 0 (element loads), a
// Cin block half past Cin (48 in blocks of 32), W 16 and 20, H not a
// multiple of the tile, batch 2, more than one block along Cout, one and
// several splits (the reduce kernel), splits of several tiles (the second
// stage buffer; the card's plan and one of about two blocks are both run),
// and units shared by 1, 2, 4 and 8 warps.
//
// With EMU_OPTS=1 it runs K6's options instead, against the same bound:
// KS = 1 (dws, the shortcut's 1x1 conv) and PRO at KS 3 (dw2 = corr(z1,
// dy2), x normalised and activated while staging: v*g + h rounded per
// operation, leaky ReLU, one rounding to bf16, at pixels inside the image
// only, so that the halo stays 0; h is chosen so that lrelu(h) is far from
// it), each with element loads at C 12.
//
// Environment: EMU_DEFER=1 lands cp.async copies at their wait; EMU_OPTS=1
// runs the options.  Built and run by tests/test_torch_cuda_emu.py, which
// generates conv3x3_dw_tc_emu.cuh.
#include <random>

#include "conv3x3_dw_tc_emu.cuh"

using namespace smsut;

namespace {

struct Shape { int B, H, W, C, Co; };
std::mt19937 rng(2);
std::normal_distribution<float> nd(0.f, 1.f);

float act_ref(float v, float g, float h) {
  const float p = v * g, a = p + h;
  return __bfloat162float(__float2bfloat16(a >= 0.f ? a : 0.01f * a));
}

template <int KS, bool PRO>
int run_case(const char* what, const Shape& s) {
  constexpr int R = KS / 2;
  const size_t nx = (size_t)s.B * s.H * s.W * s.C,
               ng = (size_t)s.B * s.H * s.W * s.Co,
               nw = (size_t)KS * KS * s.C * s.Co;
  std::vector<bf16> xbuf(nx + 8), g(ng);
  bf16* x = xbuf.data() + (s.C % 8 ? 1 : 0);
  for (size_t i = 0; i < nx; ++i) x[i] = __float2bfloat16(nd(rng));
  for (auto& v : g) v = __float2bfloat16(nd(rng));
  // PRO's (g, h) [B][2][C]: g about 1, h about 0.8
  std::vector<float> gh((size_t)s.B * 2 * s.C);
  for (int b = 0; b < s.B; ++b)
    for (int c = 0; c < s.C; ++c) {
      gh[(size_t)b * 2 * s.C + c] = 1.f + 0.3f * nd(rng);
      gh[(size_t)b * 2 * s.C + s.C + c] = 0.8f + 0.5f * nd(rng);
    }
  std::vector<double> ref(nw, 0.0), mag(nw, 0.0);
  for (int b = 0; b < s.B; ++b)
    for (int i = 0; i < s.H; ++i)
      for (int j = 0; j < s.W; ++j)
        for (int u = 0; u < KS; ++u)
          for (int v = 0; v < KS; ++v) {
            const int ih = i + u - R, iw = j + v - R;
            if (ih < 0 || ih >= s.H || iw < 0 || iw >= s.W) continue;
            for (int ci = 0; ci < s.C; ++ci) {
              double xv = __bfloat162float(
                  x[((size_t)(b * s.H + ih) * s.W + iw) * s.C + ci]);
              if (PRO)
                xv = act_ref((float)xv, gh[(size_t)b * 2 * s.C + ci],
                             gh[(size_t)b * 2 * s.C + s.C + ci]);
              for (int co = 0; co < s.Co; ++co) {
                const double p = xv * __bfloat162float(
                    g[((size_t)(b * s.H + i) * s.W + j) * s.Co + co]);
                const size_t o = ((size_t)(u * KS + v) * s.C + ci) * s.Co + co;
                ref[o] += p;
                mag[o] += std::fabs(p);
              }
            }
          }
  int failed = 0;
  // the card's plan, and one of about two blocks: few splits of many
  // tiles
  for (int target : {kDwTcTarget, 2}) {
    int nsplit, tps;
    dw_tc_plan(s.B, s.H, s.W, s.C, s.Co, &nsplit, &tps, target);
    std::vector<float> part(
        dw_tc_part_elems(s.B, s.H, s.W, s.C, s.Co, target, KS) + 1);
    std::vector<float> dw[2];
    int rc[2];
    for (int run = 0; run < 2; ++run) {
      dw[run].assign(nw, NAN);
      rc[run] = conv3x3_dw_tc<KS, PRO>(x, g.data(), part.data(),
                                       dw[run].data(), s.B, s.H, s.W, s.C,
                                       s.Co, nullptr, target, gh.data());
    }
    double worst = 0;
    size_t bad = 0;
    for (size_t i = 0; i < nw; ++i) {
      const double e = std::fabs(dw[0][i] - ref[i]) / (1e-5 * mag[i] + 1e-30);
      if (!(e <= 1.0)) ++bad;
      if (!(e <= worst)) worst = e;
    }
    const bool same = memcmp(dw[0].data(), dw[1].data(), nw * 4) == 0;
    const bool ok = rc[0] == 0 && rc[1] == 0 && bad == 0 && same;
    printf("%s B%d H%d W%d C%d Cout%d (MC %d NC %d, %d splits of %d tiles): "
           "rc %d, worst %.3g of the bound, %zu over it, runs equal %d: %s\n",
           what, s.B, s.H, s.W, s.C, s.Co, dw_tc_mc(s.C), dw_tc_nc(s.Co),
           nsplit, tps, rc[0], worst, bad, same, ok ? "ok" : "FAILED");
    failed += !ok;
  }
  return failed;
}

int run_options() {
  int failed = 0;
  for (Shape s : {Shape{2, 9, 20, 16, 16}, Shape{1, 8, 16, 48, 32},
                  Shape{1, 4, 16, 12, 16}})
    failed += run_case<1, false>("ks1", s);
  for (Shape s : {Shape{2, 16, 20, 16, 16}, Shape{1, 9, 16, 32, 64},
                  Shape{1, 4, 16, 12, 32}})
    failed += run_case<3, true>("pro", s);
  return failed;
}

}  // namespace

int main() {
  if (getenv("EMU_DEFER")) emu_defer = true;
  if (getenv("EMU_OPTS")) {
    const int failed = run_options();
    const long conflicts = emu_conflicts.load();
    printf("ldmatrix %ld, bank-conflicted phases %ld\n", emu_ldmatrix.load(),
           conflicts);
    printf("%s\n", failed || conflicts ? "FAIL" : "OK");
    return failed || conflicts ? 1 : 0;
  }
  const std::vector<Shape> shapes = {
      {2, 16, 20, 8, 16}, {2, 9, 16, 32, 64}, {1, 4, 16, 12, 32},
      {1, 3, 16, 48, 16}, {1, 8, 16, 16, 48}};
  int failed = 0;
  for (const Shape& s : shapes) {
    const size_t nx = (size_t)s.B * s.H * s.W * s.C,
                 ng = (size_t)s.B * s.H * s.W * s.Co, nw = 9 * s.C * s.Co;
    std::vector<bf16> xbuf(nx + 8), g(ng);
    bf16* x = xbuf.data() + (s.C % 8 ? 1 : 0);
    for (size_t i = 0; i < nx; ++i) x[i] = __float2bfloat16(nd(rng));
    for (auto& v : g) v = __float2bfloat16(nd(rng));
    std::vector<double> ref(nw, 0.0), mag(nw, 0.0);
    for (int b = 0; b < s.B; ++b)
      for (int i = 0; i < s.H; ++i)
        for (int j = 0; j < s.W; ++j)
          for (int u = 0; u < 3; ++u)
            for (int v = 0; v < 3; ++v) {
              const int ih = i + u - 1, iw = j + v - 1;
              if (ih < 0 || ih >= s.H || iw < 0 || iw >= s.W) continue;
              for (int ci = 0; ci < s.C; ++ci) {
                const double xv = __bfloat162float(
                    x[((size_t)(b * s.H + ih) * s.W + iw) * s.C + ci]);
                for (int co = 0; co < s.Co; ++co) {
                  const double p = xv * __bfloat162float(
                      g[((size_t)(b * s.H + i) * s.W + j) * s.Co + co]);
                  const size_t o = ((size_t)(u * 3 + v) * s.C + ci) * s.Co + co;
                  ref[o] += p;
                  mag[o] += std::fabs(p);
                }
              }
            }
    // the card's plan, and one of about two blocks: few splits of many
    // tiles
    for (int target : {kDwTcTarget, 2}) {
      int nsplit, tps;
      dw_tc_plan(s.B, s.H, s.W, s.C, s.Co, &nsplit, &tps, target);
      std::vector<float> part(
          dw_tc_part_elems(s.B, s.H, s.W, s.C, s.Co, target) + 1);
      std::vector<float> dw[2];
      int rc[2];
      for (int run = 0; run < 2; ++run) {
        dw[run].assign(nw, NAN);
        rc[run] = conv3x3_dw_tc(x, g.data(), part.data(), dw[run].data(),
                                s.B, s.H, s.W, s.C, s.Co, nullptr, target);
      }
      double worst = 0;
      size_t bad = 0;
      for (size_t i = 0; i < nw; ++i) {
        const double e =
            std::fabs(dw[0][i] - ref[i]) / (1e-5 * mag[i] + 1e-30);
        if (!(e <= 1.0)) ++bad;
        if (!(e <= worst)) worst = e;
      }
      const bool same = memcmp(dw[0].data(), dw[1].data(), nw * 4) == 0;
      const bool ok = rc[0] == 0 && rc[1] == 0 && bad == 0 && same;
      printf("B%d H%d W%d C%d Cout%d (MC %d NC %d, %d splits of %d tiles): "
             "rc %d, worst %.3g of the bound, %zu over it, runs equal %d: "
             "%s\n",
             s.B, s.H, s.W, s.C, s.Co, dw_tc_mc(s.C), dw_tc_nc(s.Co), nsplit,
             tps, rc[0], worst, bad, same, ok ? "ok" : "FAILED");
      failed += !ok;
    }
  }
  const long conflicts = emu_conflicts.load();
  printf("ldmatrix %ld, bank-conflicted phases %ld\n", emu_ldmatrix.load(),
         conflicts);
  printf("%s\n", failed || conflicts ? "FAIL" : "OK");
  return failed || conflicts ? 1 : 0;
}
