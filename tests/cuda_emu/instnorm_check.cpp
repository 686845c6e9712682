// Runs K1's kernels (smsut_tpu_torch/csrc/instnorm.cuh) on the CPU through
// the emulation of shim.h, prims.h and cooperative_groups.h, under both
// plans, and holds mean, rstd and y against a float64 reference of the same
// inputs: mean within 2e-5 of |mean| + std, rstd within 2e-5 of its value,
// y within 2e-5 (float32)
// or one bf16 unit (bfloat16) of max(1, |y|).  Outputs start as NaN, so an
// unwritten element fails.  Each case also checks that y is exactly what
// the emitted mean and rstd give (a block of a cluster that added the
// partials in another order would differ), that a second run agrees bit for
// bit, and that the calls leave every ticket zero (every case shares one
// array, as the calls on one stream do).
//
// Cases: C 3 and 12 (bf16: the scalar path, a thread layout of 3 units per
// pixel without lane reduction), C 8, 16, 24, 32 and 256 (the vector path;
// units per pixel 1-64, lane or row reduction), channel groups, clusters of
// 4 and 16 blocks (one with empty blocks), a cluster of one, the two-pass
// plan with several splits, and the plan each shape gets.  The tickets'
// array is cut to 3 and the card's fill to 8 blocks
// (tests/test_torch_cuda_emu.py, norm_check.h), so (sample, group) pairs share tickets
// and the grids stay small.
//
// With EMU_PLAN="hw,c" it checks instead that the plans of K1, K4 and K6's
// sums for that map and channel count cover every pixel and channel once,
// at batch 1 and 8, in float32 and bfloat16.
//
// Environment: EMU_DEFER=1 lands cp.async copies at their wait; EMU_OPTIN
// shrinks a block's shared memory; EMU_CLUSTERS caps the clusters that run
// at once.  Built and run by tests/test_torch_norm_emu.py.
#include <random>

#include "norm_check.h"

using namespace smsut;

namespace {

std::mt19937 rng(1);
std::normal_distribution<float> nd(0.f, 1.f);

template <typename T>
int run_plan(const char* what, int B, int H, int W, int C, NormPlan p,
             bool act) {
  const int HW = H * W;
  const size_t n = (size_t)B * HW * C;
  std::vector<T> x(n), y(n), y2(n);
  for (auto& v : x) v = from_f<T>(2.f * nd(rng) + 0.3f);
  std::vector<float> scale(C), bias(C);
  for (int c = 0; c < C; ++c) {
    scale[c] = 1.f + 0.1f * nd(rng);
    bias[c] = 0.1f * nd(rng);
  }
  const float nan = std::nanf("");
  std::vector<float> mean(B * C), rstd(B * C), mean2(B * C), rstd2(B * C);
  std::vector<float> scratch(norm_scratch_elems(p, B, C, 2) + 1);
  for (int run = 0; run < 2; ++run) {
    std::vector<T>& yo = run ? y2 : y;
    std::vector<float>& mo = run ? mean2 : mean;
    std::vector<float>& ro = run ? rstd2 : rstd;
    std::fill(yo.begin(), yo.end(), from_f<T>(nan));
    std::fill(mo.begin(), mo.end(), nan);
    std::fill(ro.begin(), ro.end(), nan);
    std::fill(scratch.begin(), scratch.end(), nan);
    if (in_fwd<T>(p, x.data(), scale.data(), bias.data(), yo.data(),
                  mo.data(), ro.data(), scratch.data(), emu_tickets.data(), B,
                  HW, C, act, nullptr) != cudaSuccess)
      return fail(what, "launch refused");
  }
  double e_stat = 0, e_y = 0;
  bool exact = true;
  const double tol_y = sizeof(T) == 2 ? 1.0 / 128 : 2e-5;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < C; ++c) {
      double s1 = 0, s2 = 0;
      for (int i = 0; i < HW; ++i) {
        const double v = to_f(x[((size_t)b * HW + i) * C + c]);
        s1 += v;
        s2 += v * v;
      }
      const double m = s1 / HW, r = 1 / std::sqrt(s2 / HW - m * m + 1e-5);
      const int bc = b * C + c;
      // the mean's error against its scale, |mean| + std
      e_stat = std::max({e_stat, std::fabs(mean[bc] - m) * r / (1 + std::fabs(m) * r),
                         rel(rstd[bc], r)});
      for (int i = 0; i < HW; ++i) {
        const size_t o = ((size_t)b * HW + i) * C + c;
        double z = (to_f(x[o]) - m) * r * scale[c] + bias[c];
        if (act && z < 0) z *= 0.01;
        e_y = std::max(e_y, std::fabs(to_f(y[o]) - z) / std::max(1.0,
                                                                  std::fabs(z)));
        float f = (to_f(x[o]) - mean[bc]) * rstd[bc];
        f = f * scale[c] + bias[c];
        if (act) f = lrelu(f);
        exact &= same(from_f<T>(f), y[o]);
      }
    }
  const bool bitwise = same_bits(y, y2) && same_bits(mean, mean2) &&
                       same_bits(rstd, rstd2);
  const bool clear = tickets_clear();
  printf("%s %s [%d,%d,%d,%d] act %d: %s, stats err %.3g, y err %.3g, "
         "exact %d, bit for bit %d, tickets clear %d\n",
         what, dtype_name<T>(), B, H, W, C, (int)act, plan_str(p).c_str(),
         e_stat, e_y, (int)exact, (int)bitwise, (int)clear);
  return e_stat <= 2e-5 && e_y <= tol_y && exact && bitwise && clear ? 0 : 1;
}

// the plan the shape gets, its two-pass and its resident plan; with `hand`,
// also a cluster of 4 blocks and the widest group, one of 16 (with empty
// blocks when 15 * rows >= H*W) and the narrowest, and two-pass splits of
// the narrowest
template <typename T>
int run_shape(int B, int H, int W, int C, bool act, bool hand = true) {
  const int HW = H * W, esz = sizeof(T);
  int bad = 0;
  bad += run_plan<T>("auto", B, H, W, C, in_fwd_plan<T>(B, HW, C), act);
  bad += run_plan<T>("two-pass", B, H, W, C,
                     norm_two_pass_plan(B, HW, C, esz, 1, 2), act);
  const NormPlan wide = norm_resident_plan(B, HW, C, esz, emu_optin);
  bad += run_plan<T>("resident", B, H, W, C, wide, act);
  if (!hand) return bad;
  bad += run_plan<T>("resident K4", B, H, W, C,
                     hand_plan(1, HW, C, esz, wide.ng, 4, 2), act);
  const int narrow = narrowest_groups(C, esz);
  bad += run_plan<T>("resident K16", B, H, W, C,
                     hand_plan(1, HW, C, esz, narrow, 16, 2), act);
  bad += run_plan<T>("two-pass 5 splits", B, H, W, C,
                     hand_plan(0, HW, C, esz, narrow, 5, 2), act);
  return bad;
}

}  // namespace

int main() {
  emu_setup();
  if (getenv("EMU_PLAN")) return check_plans();
  int bad = 0;
  for (int C : {3, 8, 16, 32}) {
    bad += run_shape<float>(2, 12, 10, C, true, false);
    bad += run_shape<bf16>(2, 12, 10, C, C % 2 == 0);
  }
  bad += run_shape<bf16>(3, 5, 7, 12, true);
  bad += run_shape<bf16>(2, 9, 4, 24, false);
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
