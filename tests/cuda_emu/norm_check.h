// Pieces shared by the check programs of K1 and K4 (instnorm_check.cpp,
// instnorm_bwd_check.cpp): plans made by hand, the tickets, comparisons,
// the plan coverage check, and the environment.
#pragma once
#include <cmath>
#include <string>
#include <vector>

#include "instnorm_bwd_emu.cuh"

namespace {

using namespace smsut;

inline int fail(const char* what, const char* why) {
  printf("%s: %s\n", what, why);
  return 1;
}

inline double rel(double got, double want) {
  return std::isfinite(got) ? std::fabs(got - want) / std::fabs(want) : 1e30;
}

inline bool same(float a, float b) { return !memcmp(&a, &b, 4); }
inline bool same(bf16 a, bf16 b) { return a.x == b.x; }
template <typename T>
bool same_bits(const std::vector<T>& a, const std::vector<T>& b) {
  return !memcmp(a.data(), b.data(), a.size() * sizeof(T));
}

template <typename T> const char* dtype_name() {
  return sizeof(T) == 2 ? "bf16" : "f32";
}

// the tickets of every call, as the wrapper keeps them for a stream: zero
// before the first call, and left zero by each
inline std::vector<unsigned int> emu_tickets(kNormTicketWords);
inline bool tickets_clear() {
  for (unsigned int t : emu_tickets)
    if (t) return false;
  return true;
}

inline std::string plan_str(const NormPlan& p) {
  char s[160];
  snprintf(s, sizeof s,
           "%s %s groups %d of %d (%d units), %d blocks of %d pixels, smem %d",
           p.resident ? "resident" : "two-pass", p.vec ? "vec" : "scalar",
           p.ng, p.G, p.U, p.nsplit, p.rows, p.smem);
  return s;
}

// the most channel groups the plans allow for C channels of esz bytes
inline int narrowest_groups(int C, int esz) {
  const int V = (C * esz) % 16 == 0 ? 16 / esz : 1;
  int best = 1;
  for (int ng = 2; ng <= C; ++ng) {
    const int G = C / ng;
    if (C % ng || G % V || G * esz < kNormMinGroupBytes) continue;
    best = ng;
  }
  return best;
}

// a plan of ng groups and K blocks per (sample, group): K1's resident plan,
// or a two-pass plan taking NS sums
inline NormPlan hand_plan(int resident, int HW, int C, int esz, int ng, int K,
                          int NS) {
  NormPlan p{};
  p.resident = resident;
  p.vec = (C * esz) % 16 == 0;
  const int V = p.vec ? 16 / esz : 1;
  p.ng = ng;
  p.G = C / ng;
  p.U = p.G / V;
  p.nsplit = K;
  p.rows = (HW + K - 1) / K;
  p.smem = resident ? norm_resident_smem(p.rows, p.G, p.U, esz, V)
                    : norm_red_floats(p.U, NS, V) * 4 + 16;
  return p;
}

// whether plan p of a map of HW pixels and C channels covers every pixel
// and channel once, in whole units, within the device's shared memory
inline bool covers(const NormPlan& p, int HW, int C, int esz) {
  const int V = p.vec ? 16 / esz : 1;
  return p.vec == ((C * esz) % 16 == 0) && p.ng >= 1 && p.ng * p.G == C &&
         p.U * V == p.G && p.U <= kNormThreads && p.rows >= 1 &&
         (long long)p.nsplit * p.rows >= HW &&
         (long long)(p.nsplit - 1) * p.rows < HW + (p.resident ? p.rows : 0) &&
         (p.ng == 1 || p.G * esz >= kNormMinGroupBytes) &&
         (!p.resident || p.nsplit <= kNormMaxCluster) &&
         p.smem <= emu_optin;
}

// EMU_PLAN="hw,c": the plans of K1, K4 and K6's two sums passes; only
// K1's may be resident
inline int check_plans() {
  int hw = 0, c = 0;
  if (sscanf(getenv("EMU_PLAN"), "%d,%d", &hw, &c) != 2) return 2;
  int bad = 0;
  for (int B : {1, 8}) {
    const NormPlan ps[] = {in_fwd_plan<float>(B, hw, c),
                           in_fwd_plan<bf16>(B, hw, c),
                           in_bwd_plan<float>(B, hw, c),
                           in_bwd_plan<bf16>(B, hw, c),
                           norm_two_pass_plan(B, hw, c, 4, 3, 3),
                           norm_two_pass_plan(B, hw, c, 2, 3, 3)};
    const char* names[] = {"K1 f32", "K1 bf16", "K4 f32", "K4 bf16",
                           "K6 sums f32", "K6 sums bf16"};
    for (int i = 0; i < 6; ++i) {
      const bool ok = covers(ps[i], hw, c, i % 2 ? 2 : 4) &&
                      (i < 2 || !ps[i].resident);
      printf("plan %s B %d hw %d c %d: %s: covers %d\n", names[i], B, hw, c,
             plan_str(ps[i]).c_str(), (int)ok);
      bad += !ok;
    }
  }
  printf("bank-conflicted phases 0\n");
  printf(bad ? "plans failed\n" : "OK\n");
  return bad ? 1 : 0;
}

inline void emu_setup() {
  // the card's fill and smallest resident slice for the plans' coverage,
  // else 8 blocks and any slice, so that the small maps of the checks run
  // resident where they fit
  if (!getenv("EMU_PLAN")) {
    kNormFill = 8;
    kNormMinResidentBytes = 0;
  }
  if (getenv("EMU_DEFER")) emu_defer = true;
  if (getenv("EMU_OPTIN")) emu_optin = atoi(getenv("EMU_OPTIN"));
  if (getenv("EMU_CLUSTERS")) emu_max_clusters = atoi(getenv("EMU_CLUSTERS"));
}

}  // namespace
