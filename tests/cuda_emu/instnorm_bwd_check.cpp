// Runs K4's kernels (smsut_tpu_torch/csrc/instnorm_bwd.cuh) on the CPU
// through the emulation of shim.h and prims.h, under the plan each shape
// gets and others of the same kind (two passes), and holds dx, dscale and
// dbias against a float64 reference of
// the same inputs: dx within 2e-5 (float32) or one bf16 unit (bfloat16) of
// max(1, |dx|), dscale and dbias within 1e-5 of the sum of the magnitudes
// of their terms.  The reference takes the leaky-ReLU mask as the kernel
// does (y >= 0 from float32 xhat, product and sum rounded apart), so a
// rounding at 0 flips no element.  Outputs start as NaN, so an unwritten
// element fails.  Each case also checks that dx is exactly what the
// per-sample sums the kernel left in its scratch give, and dscale and dbias
// exactly their sums over the samples in order (a block that added the
// partials in another order would differ), that a second run agrees bit for
// bit, and that the calls leave every ticket zero (every case shares one
// array, as the calls on one stream do).
//
// Cases: the shapes of instnorm_check.cpp (C 3, 8, 16, 32, 12, 24, 256;
// the scalar and the vector path, lane and row reduction), each with and
// without the activation's mask, under the plan it gets, one split, and
// the widest and the narrowest groups in 5 splits.  The tickets' array is
// cut to 3 and the card's fill to 8 blocks (tests/test_torch_cuda_emu.py,
// norm_check.h), so (sample, group) pairs share tickets.
//
// Environment: EMU_DEFER=1 and EMU_CLUSTERS are K1's (instnorm_check.cpp);
// K4 stages nothing and runs no cluster.  Built and run by
// tests/test_torch_norm_emu.py.
#include <random>

#include "norm_check.h"

using namespace smsut;

namespace {

std::mt19937 rng(2);
std::normal_distribution<float> nd(0.f, 1.f);

template <typename T>
int run_plan(const char* what, int B, int H, int W, int C, NormPlan p,
             bool act) {
  const int HW = H * W;
  const size_t n = (size_t)B * HW * C;
  std::vector<T> x(n), g(n), dx(n), dx2(n);
  for (auto& v : x) v = from_f<T>(2.f * nd(rng) + 0.3f);
  for (auto& v : g) v = from_f<T>(nd(rng));
  std::vector<float> scale(C), bias(C), mean(B * C), rstd(B * C);
  for (int c = 0; c < C; ++c) {
    scale[c] = 1.f + 0.1f * nd(rng);
    bias[c] = 0.1f * nd(rng);
  }
  // the forward's statistics, in float64, stored as float32
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < C; ++c) {
      double s1 = 0, s2 = 0;
      for (int i = 0; i < HW; ++i) {
        const double v = to_f(x[((size_t)b * HW + i) * C + c]);
        s1 += v;
        s2 += v * v;
      }
      const double m = s1 / HW;
      mean[b * C + c] = (float)m;
      rstd[b * C + c] = (float)(1 / std::sqrt(s2 / HW - m * m + 1e-5));
    }
  const NormBwdSrc<T> src{x.data(), g.data(), mean.data(), rstd.data(),
                          scale.data(), bias.data(), HW, C, (int)act};
  const float nan = std::nanf("");
  std::vector<float> dsb(2 * C), dsb2(2 * C);
  std::vector<float> scratch(norm_scratch_elems(p, B, C, 2) + 1);
  std::vector<float> sums(2 * (size_t)B * C);
  for (int run = 0; run < 2; ++run) {
    std::vector<T>& o = run ? dx2 : dx;
    std::vector<float>& so = run ? dsb2 : dsb;
    std::fill(o.begin(), o.end(), from_f<T>(nan));
    std::fill(so.begin(), so.end(), nan);
    std::fill(scratch.begin(), scratch.end(), nan);
    if (in_bwd<T>(p, src, o.data(), so.data(), scratch.data(),
                  emu_tickets.data(), B, nullptr) != cudaSuccess)
      return fail(what, "launch refused");
    if (!run) std::copy(scratch.begin(), scratch.begin() + sums.size(),
                        sums.begin());
  }
  double e_dx = 0, e_sb = 0;
  bool exact = true;
  const double tol_dx = sizeof(T) == 2 ? 1.0 / 128 : 2e-5;
  std::vector<double> rd(C), rdx(C), ad(C), adx(C);
  for (int b = 0; b < B; ++b) {
    const float* S = sums.data() + (size_t)b * 2 * C;
    for (int c = 0; c < C; ++c) {
      const int bc = b * C + c;
      double sd = 0, sdx = 0, asd = 0, asdx = 0;
      std::vector<double> d(HW), xh(HW);
      for (int i = 0; i < HW; ++i) {
        const size_t o = ((size_t)b * HW + i) * C + c;
        const float xhf = (to_f(x[o]) - mean[bc]) * rstd[bc];
        const bool neg = act && !(xhf * scale[c] + bias[c] >= 0.f);
        d[i] = to_f(g[o]) * (neg ? 0.01 : 1.0);
        xh[i] = ((double)to_f(x[o]) - mean[bc]) * rstd[bc];
        sd += d[i];
        sdx += d[i] * xh[i];
        asd += std::fabs(d[i]);
        asdx += std::fabs(d[i] * xh[i]);
      }
      rd[c] += sd;
      rdx[c] += sdx;
      ad[c] += asd;
      adx[c] += asdx;
      const double a = (double)scale[c] * rstd[bc];
      for (int i = 0; i < HW; ++i) {
        const size_t o = ((size_t)b * HW + i) * C + c;
        const double want = a * (d[i] - sd / HW - xh[i] * (sdx / HW));
        e_dx = std::max(e_dx, std::fabs(to_f(dx[o]) - want) /
                                  std::max(1.0, std::fabs(want)));
        // dx from the kernel's own sums, as the kernel computes it
        float dv, xv;
        src.d_xh(to_f(x[o]), to_f(g[o]),
                 typename NormBwdSrc<T>::template Chan<1>(src, b, c), 0, dv,
                 xv);
        const float af = scale[c] * rstd[bc], nf = (float)HW;
        const float f = af * (dv - S[c] / nf - xv * (S[C + c] / nf));
        exact &= same(from_f<T>(f), dx[o]);
      }
    }
  }
  for (int c = 0; c < C; ++c) {
    e_sb = std::max({e_sb, std::fabs(dsb[c] - rd[c]) / std::max(ad[c], 1e-30),
                     std::fabs(dsb[C + c] - rdx[c]) /
                         std::max(adx[c], 1e-30)});
    float v0 = 0.f, v1 = 0.f;
    for (int b = 0; b < B; ++b) {
      v0 += sums[(size_t)b * 2 * C + c];
      v1 += sums[(size_t)b * 2 * C + C + c];
    }
    exact &= same(v0, dsb[c]) && same(v1, dsb[C + c]);
  }
  const bool bitwise = same_bits(dx, dx2) && same_bits(dsb, dsb2);
  const bool clear = tickets_clear();
  printf("%s %s [%d,%d,%d,%d] act %d: %s, dx err %.3g, dscale/dbias err "
         "%.3g, exact %d, bit for bit %d, tickets clear %d\n",
         what, dtype_name<T>(), B, H, W, C, (int)act, plan_str(p).c_str(),
         e_dx, e_sb, (int)exact, (int)bitwise, (int)clear);
  return e_dx <= tol_dx && e_sb <= 1e-5 && exact && bitwise && clear ? 0 : 1;
}

// the plan the shape gets; with `hand`, also one split of the widest
// group, and 5 splits of the widest and of the narrowest
template <typename T>
int run_shape(int B, int H, int W, int C, bool act, bool hand = true) {
  const int HW = H * W, esz = sizeof(T);
  int bad = 0;
  const NormPlan p = in_bwd_plan<T>(B, HW, C);
  bad += run_plan<T>("auto", B, H, W, C, p, act);
  if (!hand) return bad;
  bad += run_plan<T>("two-pass 1 split", B, H, W, C,
                     hand_plan(0, HW, C, esz, 1, 1, 2), act);
  bad += run_plan<T>("two-pass 5 splits wide", B, H, W, C,
                     hand_plan(0, HW, C, esz, 1, 5, 2), act);
  bad += run_plan<T>("two-pass 5 splits", B, H, W, C,
                     hand_plan(0, HW, C, esz, narrowest_groups(C, esz), 5, 2),
                     act);
  return bad;
}

}  // namespace

int main() {
  emu_setup();
  int bad = 0;
  for (int C : {3, 8, 16, 32}) {
    bad += run_shape<float>(2, 12, 10, C, C % 2 == 1, false);
    bad += run_shape<bf16>(2, 12, 10, C, true);
  }
  bad += run_shape<bf16>(3, 5, 7, 12, false);
  bad += run_shape<float>(2, 9, 4, 24, true);
  bad += run_shape<bf16>(1, 4, 4, 256, true, false);
  bad += run_shape<float>(2, 3, 4, 256, false, false);
  printf("bank-conflicted phases %ld\n", (long)emu_conflicts);
  if (bad) {
    printf("%d failed\n", bad);
    return 1;
  }
  printf("OK\n");
  return 0;
}
