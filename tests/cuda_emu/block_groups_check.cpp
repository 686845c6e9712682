// K3's finalize step and K6's pooling of its norm sums on the packed map
// (groups 4: channel s*C + c of original channel c) and on the unpacked
// map (groups 1), from smsut_tpu_torch/csrc/common.cuh (finalize_kernel,
// finalize_groups_kernel, launch_finalize) and block_bwd.cuh
// (pool_group_sums_kernel, pool_group_sums), on the CPU through the
// emulation of shim.h.
//
// finalize: random partials part[B][nt][2][C]; mean, rstd and (g, h) of
// every packed channel bit for bit against a float reference that adds in
// the kernels' order (each group's partials in tile order, then the groups
// s = 0..G-1), within 1e-5 of a float64 reference, and the same at the 4
// members of each group.  Outputs start as NaN, so an unwritten element
// fails.  pool_group_sums: rows [R][C] of sums, in place, bit for bit
// against the float reference of its order; groups 1 leaves them as they
// are.  Channel counts 3, 16 and 130 per group (130: two blocks of 128).
// Built and run by tests/test_torch_cuda_emu.py.
#include <cmath>
#include <cstring>
#include <random>
#include <vector>

#include "shim.h"
#include "common_emu.cuh"
#include "block_groups_emu.cuh"

using namespace smsut;

namespace {

std::mt19937 rng(3);
std::normal_distribution<float> nd(0.f, 1.f);

bool same(float a, float b) { return !memcmp(&a, &b, 4); }

int finalize_case(int B, int Cg, int G, int nt, int n) {
  const int C = Cg * G;
  std::vector<float> part((size_t)B * nt * 2 * C);
  for (size_t i = 0; i < part.size(); ++i)
    part[i] = (i / C) % 2 ? 2.f + std::fabs(nd(rng)) : nd(rng);
  std::vector<float> scale(Cg), bias(Cg);
  for (int c = 0; c < Cg; ++c) {
    scale[c] = 1.f + 0.1f * nd(rng);
    bias[c] = 0.1f * nd(rng);
  }
  const float nan = std::nanf("");
  std::vector<float> mean(B * C, nan), rstd(B * C, nan), gh(2 * B * C, nan);
  launch_finalize(part.data(), nt, B, C, n, scale.data(), bias.data(),
                  mean.data(), rstd.data(), gh.data(), nullptr, G);
  int bad = 0;
  double worst = 0;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < Cg; ++c) {
      const float* p = part.data() + (size_t)b * nt * 2 * C;
      float s1 = 0.f, s2 = 0.f;
      double d1 = 0, d2 = 0;
      for (int q = 0; q < G; ++q) {
        float t1 = 0.f, t2 = 0.f;
        for (int t = 0; t < nt; ++t) {
          t1 += p[(size_t)(2 * t) * C + q * Cg + c];
          t2 += p[(size_t)(2 * t + 1) * C + q * Cg + c];
          d1 += p[(size_t)(2 * t) * C + q * Cg + c];
          d2 += p[(size_t)(2 * t + 1) * C + q * Cg + c];
        }
        s1 = q ? s1 + t1 : t1;
        s2 = q ? s2 + t2 : t2;
      }
      const float N = (float)n * (float)G;
      const float m = s1 / N, var = s2 / N - m * m;
      const float r = 1.f / sqrtf(var + kEps);
      const float g = scale[c] * r, h = bias[c] - m * g;
      const double dm = d1 / ((double)n * G);
      const double dr = 1.0 / std::sqrt(d2 / ((double)n * G) - dm * dm + 1e-5);
      for (int q = 0; q < G; ++q) {
        const size_t o = (size_t)b * C + q * Cg + c;
        const size_t og = (size_t)(2 * b) * C + q * Cg + c;
        // the kernel's product and difference may fuse where the
        // reference's do not: g and h within 2 float units of the order's
        const bool ok = same(mean[o], m) && same(rstd[o], r) &&
                        std::fabs(gh[og] - g) <= 2e-7f * std::fabs(g) &&
                        std::fabs(gh[og + C] - h) <=
                            2e-7f * (std::fabs(h) + std::fabs(m * g));
        const double e = std::max(std::fabs(mean[o] - dm) /
                                      (std::fabs(dm) + 1.0 / dr),
                                  std::fabs(rstd[o] - dr) / dr);
        worst = std::max(worst, e);
        bad += !ok || !(e <= 1e-5);
      }
    }
  printf("finalize B%d C%d groups %d tiles %d n %d: worst %.3g against "
         "float64, %d of %d channels off: %s\n",
         B, C, G, nt, n, worst, bad, B * C, bad ? "FAILED" : "ok");
  return bad != 0;
}

int pool_case(int R, int Cg, int G) {
  const int C = Cg * G;
  std::vector<float> s((size_t)R * C);
  for (auto& v : s) v = nd(rng);
  std::vector<float> want = s;
  for (int r = 0; r < R; ++r)
    for (int c = 0; c < Cg; ++c) {
      float* p = want.data() + (size_t)r * C + c;
      float t = p[0];
      for (int q = 1; q < G; ++q) t += p[(size_t)q * Cg];
      for (int q = 0; q < G; ++q) p[(size_t)q * Cg] = t;
    }
  pool_group_sums(s.data(), R, C, G, nullptr);
  const bool ok = !memcmp(s.data(), want.data(), s.size() * 4);
  printf("pool_group_sums rows %d C%d groups %d: %s\n", R, C, G,
         ok ? "ok" : "FAILED");
  return !ok;
}

}  // namespace

int main() {
  int failed = 0;
  for (int G : {1, 4})
    for (int Cg : {3, 16, 130}) {
      failed += finalize_case(2, Cg, G, 3, 37);
      failed += pool_case(5, Cg, G);
    }
  printf("%s\n", failed ? "FAIL" : "OK");
  return failed ? 1 : 0;
}
