// Host emulation of the PTX primitives of smsut_tpu_torch/csrc/mma_tile.cuh,
// written from the PTX ISA and independent of the kernel's own index
// helpers: ldmatrix (.x4, .x2, .trans), mma.sync.m16n8k16 bf16 with float32
// accumulators, cp.async with commit and wait groups, and the warp shuffle
// __shfl_xor_sync (full mask).
//
// A warp collective posts each lane's operands to a per-warp exchange
// slot of its block (shim.h), meets the warp's other lanes at a barrier,
// computes its own lane's result from all of them and meets them again.
// ldmatrix also counts the 8-address phases whose distinct row addresses
// share a group of four banks (a bank conflict).  cp.async copies at once,
// or, with emu_defer, at the wait that retires its group, so both a copy
// that lands too early and one that lands too late are tried.
#pragma once
#include <atomic>
#include <vector>

namespace smsut {

typedef __nv_bfloat16 bf16;

inline std::atomic<long> emu_ldmatrix{0}, emu_conflicts{0};
inline bool emu_defer = false;

inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

inline uint16_t emu_ld16(uint32_t addr) {
  uint16_t v;
  memcpy(&v, emu_smem + addr, 2);
  return v;
}

// ldmatrix of nm (1, 2 or 4) 8x8 matrices: lanes 8i..8i+7 give the row
// addresses of matrix i (those of the lanes past 8 nm are not read)
inline void emu_ldsm(uint32_t* r, int nm, uint32_t addr, bool trans) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane < 8 * nm && addr % 16) {
    fprintf(stderr, "ldmatrix: row address %u not 16-byte aligned\n", addr);
    exit(4);
  }
  emu_xch[w][lane].addr = addr;
  emu_warp_sync();
  if (lane == 0) {
    ++emu_ldmatrix;
    for (int i = 0; i < nm; ++i) {
      uint32_t seen[8];
      bool used[8] = {}, conflict = false;
      for (int j = 0; j < 8; ++j) {
        const uint32_t ad = emu_xch[w][8 * i + j].addr;
        const int grp = (ad / 16) % 8;
        conflict |= used[grp] && seen[grp] != ad;
        seen[grp] = ad;
        used[grp] = true;
      }
      if (conflict) ++emu_conflicts;
    }
  }
  // register i: row q, elements c, c+1 of matrix i (.trans: rows c, c+1
  // of column q)
  const int q = lane / 4, c = 2 * (lane % 4);
  for (int i = 0; i < nm; ++i) {
    uint16_t lo, hi;
    if (!trans) {
      const uint32_t row = emu_xch[w][8 * i + q].addr;
      lo = emu_ld16(row + 2 * c);
      hi = emu_ld16(row + 2 * (c + 1));
    } else {
      lo = emu_ld16(emu_xch[w][8 * i + c].addr + 2 * q);
      hi = emu_ld16(emu_xch[w][8 * i + c + 1].addr + 2 * q);
    }
    r[i] = lo | ((uint32_t)hi << 16);
  }
  emu_warp_sync();
}

inline void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  emu_ldsm(r, 4, addr, false);
}
inline void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  emu_ldsm(r, 4, addr, true);
}
inline void ldmatrix_x2_trans(uint32_t r[2], uint32_t addr) {
  emu_ldsm(r, 2, addr, true);
}

inline void mma_16816(float d[4], const uint32_t a[4], uint32_t b0,
                      uint32_t b1) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int i = 0; i < 4; ++i) emu_xch[w][lane].a[i] = a[i];
  emu_xch[w][lane].b[0] = b0;
  emu_xch[w][lane].b[1] = b1;
  emu_warp_sync();
  auto lo = [](uint32_t v) { return __bfloat162float({(uint16_t)(v & 0xffff)}); };
  auto hi = [](uint32_t v) { return __bfloat162float({(uint16_t)(v >> 16)}); };
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l / 4, t = l % 4;
    const EmuLane& e = emu_xch[w][l];
    A[g][2 * t] = lo(e.a[0]);         A[g][2 * t + 1] = hi(e.a[0]);
    A[g + 8][2 * t] = lo(e.a[1]);     A[g + 8][2 * t + 1] = hi(e.a[1]);
    A[g][2 * t + 8] = lo(e.a[2]);     A[g][2 * t + 9] = hi(e.a[2]);
    A[g + 8][2 * t + 8] = lo(e.a[3]); A[g + 8][2 * t + 9] = hi(e.a[3]);
    B[2 * t][g] = lo(e.b[0]);         B[2 * t + 1][g] = hi(e.b[0]);
    B[2 * t + 8][g] = lo(e.b[1]);     B[2 * t + 9][g] = hi(e.b[1]);
  }
  const int g = lane / 4, t = lane % 4;
  for (int h = 0; h < 2; ++h)
    for (int j = 0; j < 2; ++j) {
      float s = 0.f;
      for (int k = 0; k < 16; ++k) s += A[g + 8 * h][k] * B[k][2 * t + j];
      d[2 * h + j] += s;
    }
  emu_warp_sync();
}

// every lane of the warp takes part (mask 0xffffffff): lane l gets v of
// lane l ^ m
inline float __shfl_xor_sync(unsigned mask, float v, int m) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (mask != 0xffffffffu || m < 1 || m > 31) {
    fprintf(stderr, "__shfl_xor_sync: mask %x, lane mask %d\n", mask, m);
    exit(4);
  }
  emu_xch[w][lane].f = v;
  emu_warp_sync();
  const float r = emu_xch[w][lane ^ m].f;
  emu_warp_sync();
  return r;
}

struct EmuCopy { uint32_t dst; const void* src; bool valid; };
inline std::vector<EmuCopy> emu_open;
inline std::vector<std::vector<EmuCopy>> emu_groups;

// the copies in flight, per fiber
inline std::vector<std::pair<std::vector<EmuCopy>,
                             std::vector<std::vector<EmuCopy>>>>
    emu_copy_states;
inline void emu_copy_hook(int f, bool) {
  if ((int)emu_copy_states.size() <= f) emu_copy_states.resize(f + 1);
  std::swap(emu_open, emu_copy_states[f].first);
  std::swap(emu_groups, emu_copy_states[f].second);
}
inline const bool emu_copy_hooked =
    (emu_fiber_hooks.push_back(emu_copy_hook), true);

inline void emu_copy(const EmuCopy& c) {
  if (c.valid)
    memcpy(emu_smem + c.dst, c.src, 16);
  else
    memset(emu_smem + c.dst, 0, 16);
}

inline void cp_async16(uint32_t dst, const void* src, bool valid) {
  if (dst % 16 || (uintptr_t)src % 16) {
    fprintf(stderr, "cp.async: address not 16-byte aligned\n");
    exit(4);
  }
  if (emu_defer)
    emu_open.push_back({dst, src, valid});
  else
    emu_copy({dst, src, valid});
}

inline void cp_async_commit() {
  emu_groups.push_back(emu_open);
  emu_open.clear();
}

template <int N> inline void cp_async_wait() {
  while ((int)emu_groups.size() > N) {
    for (const EmuCopy& c : emu_groups.front()) emu_copy(c);
    emu_groups.erase(emu_groups.begin());
  }
}

}  // namespace smsut
