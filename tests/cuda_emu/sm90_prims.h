// Host emulation of the Hopper primitives of smsut_tpu_torch/csrc/sm90.cuh
// (its part between the PTX markers) and of what it takes from <cuda.h>,
// written from the PTX ISA and the CUDA driver API, independent of the
// kernels' own helpers:
//
//   - mbarrier: init with an arrival count, arrive, arrive.expect_tx, and
//     try_wait.parity.  A phase completes when its arrivals are all in and
//     its transaction bytes are all landed.  A wait on a phase that can no
//     longer complete (every running thread of the block waits on a
//     barrier, for a thousand turns of the waiting fiber with no wait
//     ending), and an arrival beyond a phase's count, are reported and
//     fail the program.
//   - TMA tiled loads (cp.async.bulk.tensor, 3 and 4 dimensions) from a
//     tensor map that the emulated cuTensorMapEncodeTiled checks as the
//     CUDA driver does: zeros outside the tensor, at negative and past-the-end
//     coordinates; the 32, 64 and 128-byte swizzles.  The box is poisoned
//     (all bits set: bf16 NaN) when the load is issued and lands only when
//     a thread waits on its barrier with every arrival in, so a read before
//     the wait, or a slot refilled while it is read, shows.
//   - wgmma.mma_async bf16 -> float32: m64nNk16 with A in registers (the
//     mma.m16n8k16 A fragment of each warp) and B transposed, m64n128k16
//     with A in registers and B K-major, and m64n128k16 with A transposed
//     and B K-major, each operand in shared memory through a decoded
//     descriptor (start, LBO, SBO, base offset, swizzle); wgmma.fence,
//     commit_group and wait_group.  The products are computed at issue;
//     the accumulators read NaN until the wait_group that retires the last
//     group using them, and a batch of wgmma issued without a fence before
//     it fails.
//   - setmaxnreg.dec and .inc: each warpgroup of a block starts with the
//     registers a kernel of __launch_bounds__(threads, 1) gets (65536 /
//     threads, down to a multiple of 8); dec gives the difference to the
//     block's pool and inc waits until the pool holds what it takes.  All
//     128 threads of the warpgroup must issue the same one: a warp that
//     does not, or an inc that no dec pays for, leaves every thread
//     waiting, and that fails as a wait that cannot complete.
//   - stmatrix.x4.trans and __syncwarp (every lane).
#pragma once
#include <map>
#include <mutex>
#include <vector>

#include "shim.h"

#define __grid_constant__

typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
enum CUresult { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1 };
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle {
  CU_TENSOR_MAP_SWIZZLE_NONE = 0, CU_TENSOR_MAP_SWIZZLE_32B,
  CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_SWIZZLE_128B };
enum CUtensorMapL2promotion {
  CU_TENSOR_MAP_L2_PROMOTION_NONE = 0, CU_TENSOR_MAP_L2_PROMOTION_L2_64B,
  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B };
enum CUtensorMapFloatOOBfill {
  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0,
  CU_TENSOR_MAP_FLOAT_OOB_FILL_NAN_REQUEST_ZERO_FMA };

// the emulated map: what the CUDA driver's opaque 128 bytes encode
struct CUtensorMap {
  int rank;
  const unsigned char* base;
  uint64_t dims[5], strides[5];   // strides[d] in bytes, of dimension d+1
  uint32_t box[5];
  int swizzle;                    // bytes: 0, 32, 64, 128
};

inline int emu_encode_errors = 0;

// cuTensorMapEncodeTiled for bf16 with the CUDA driver's checks: rank 1-5, a
// 16-byte aligned address, strides multiples of 16 below 2^40, boxes of
// 1-256 elements whose inner dimension is a multiple of 16 bytes, element
// strides 1.  With a swizzle the box's inner dimension must be at most the
// swizzle's bytes; the emulation takes it equal to them (the kernels' only
// case) and refuses a narrower one rather than guess its layout.
inline CUresult emu_encode_tiled(
    CUtensorMap* m, CUtensorMapDataType dt, cuuint32_t rank, void* base,
    const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
    const cuuint32_t* estr, CUtensorMapInterleave il, CUtensorMapSwizzle sw,
    CUtensorMapL2promotion, CUtensorMapFloatOOBfill oob) {
  static const int bytes[4] = {0, 32, 64, 128};
  bool ok = dt == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 && rank >= 1 &&
            rank <= 5 && (uintptr_t)base % 16 == 0 &&
            il == CU_TENSOR_MAP_INTERLEAVE_NONE &&
            oob == CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE && (int)sw >= 0 &&
            (int)sw < 4 && box[0] * 2 % 16 == 0;
  for (cuuint32_t d = 0; ok && d < rank; ++d) {
    ok = dims[d] >= 1 && dims[d] <= (1ull << 32) && box[d] >= 1 &&
         box[d] <= 256 && estr[d] == 1;
    if (d >= 1)
      ok = ok && strides[d - 1] % 16 == 0 && strides[d - 1] < (1ull << 40);
  }
  if (ok && sw != CU_TENSOR_MAP_SWIZZLE_NONE)
    ok = (int)box[0] * 2 == bytes[sw];
  if (!ok) {
    ++emu_encode_errors;
    return CUDA_ERROR_INVALID_VALUE;
  }
  *m = CUtensorMap{};
  m->rank = (int)rank;
  m->base = (const unsigned char*)base;
  for (cuuint32_t d = 0; d < rank; ++d) {
    m->dims[d] = dims[d];
    m->box[d] = box[d];
    if (d >= 1) m->strides[d - 1] = strides[d - 1];
  }
  m->swizzle = bytes[sw];
  return CUDA_SUCCESS;
}

enum cudaDriverEntryPointQueryResult {
  cudaDriverEntryPointSuccess = 0, cudaDriverEntryPointSymbolNotFound = 1 };
enum { cudaEnableDefault = 0 };
inline cudaError_t cudaGetDriverEntryPointByVersion(
    const char* sym, void** fn, unsigned, unsigned long long,
    cudaDriverEntryPointQueryResult* q) {
  const bool found = strcmp(sym, "cuTensorMapEncodeTiled") == 0;
  *fn = found ? (void*)&emu_encode_tiled : nullptr;
  *q = found ? cudaDriverEntryPointSuccess : cudaDriverEntryPointSymbolNotFound;
  return cudaSuccess;
}

namespace smsut {

// ------------------------------------------------------------- mbarrier
struct EmuTmaCopy {
  uint32_t dst;
  CUtensorMap map;
  int coord[5];
};

struct EmuMbar {
  int count = 0, pending = 0;
  long tx = 0, phase = 0;   // phase: completed phases
  std::vector<EmuTmaCopy> copies;
};

inline std::mutex emu_mbar_mu;
inline std::map<std::pair<unsigned char*, uint32_t>, EmuMbar> emu_mbars;
inline std::atomic<int> emu_mbar_blocked_pool[kEmuMaxCluster];
inline std::atomic<long> emu_tma_loads{0}, emu_mbar_waits{0};
// waits that have ended (the fibers' deadlock check)
inline long emu_waits_ended = 0;

[[noreturn]] inline void emu_fail(const char* what) {
  fprintf(stderr, "%s (block %u, thread %u)\n", what, blockIdx.x,
          threadIdx.x);
  fflush(stderr);
  _Exit(5);
}

inline EmuMbar& emu_mbar(uint32_t bar) {
  if (bar % 8) emu_fail("mbarrier: address not 8-byte aligned");
  auto it = emu_mbars.find({emu_smem, bar});
  if (it == emu_mbars.end()) emu_fail("mbarrier: not initialised");
  return it->second;
}

inline void mbar_init(uint32_t bar, uint32_t count) {
  std::lock_guard<std::mutex> lock(emu_mbar_mu);
  if (bar % 8 || count < 1) emu_fail("mbarrier.init: bad address or count");
  EmuMbar& m = emu_mbars[{emu_smem, bar}];
  m = EmuMbar{};
  m.count = m.pending = (int)count;
  memset(emu_smem + bar, 0, 8);
}

inline void mbar_fence_init() {}

// the landing of one copy: the box, element by element, zeros outside the
// tensor, each 16-byte chunk at its swizzled place
inline long emu_land(const EmuTmaCopy& c) {
  const CUtensorMap& m = c.map;
  long n = 1;
  for (int d = 0; d < m.rank; ++d) n *= m.box[d];
  for (long e = 0; e < n; ++e) {
    long rest = e;
    bool in = true;
    const unsigned char* src = m.base;
    for (int d = 0; d < m.rank; ++d) {
      const long i = rest % m.box[d];
      rest /= m.box[d];
      const long g = (long)c.coord[d] + i;
      in = in && g >= 0 && g < (long)m.dims[d];
      if (in) src += d == 0 ? g * 2 : g * (long)m.strides[d - 1];
    }
    uint32_t a = c.dst + (uint32_t)(e * 2);
    if (m.swizzle) {
      // the chunk's index within its 128-byte row, XORed with the row's
      // place in the 8-row (1024-byte) repeat, as many bits as the swizzle
      const uint32_t rowbits = (a >> 7) & (uint32_t)(m.swizzle / 16 - 1);
      a ^= rowbits << 4;
    }
    uint16_t v = 0;
    if (in) memcpy(&v, src, 2);
    memcpy(emu_smem + a, &v, 2);
  }
  return n * 2;
}

// under the lock: with every arrival in, land the copies (`land`), and
// complete the phase once its bytes are all in
inline void emu_mbar_progress(EmuMbar& m, bool land) {
  if (m.pending != 0) return;
  if (land) {
    for (const EmuTmaCopy& c : m.copies) m.tx -= emu_land(c);
    m.copies.clear();
  }
  if (m.tx == 0) {
    ++m.phase;
    m.pending = m.count;
    }
}

// An arrival on a phase whose arrivals are all in (its bytes still on the
// way) fails: it would count towards a phase it does not belong to, as a
// slot refilled before its release does.
inline void emu_mbar_arrive(uint32_t bar, long tx) {
  std::lock_guard<std::mutex> lock(emu_mbar_mu);
  EmuMbar& m = emu_mbar(bar);
  if (m.pending == 0)
    emu_fail("mbarrier: an arrival beyond the phase's count");
  m.tx += tx;
  --m.pending;
  emu_mbar_progress(m, false);
}

inline void mbar_arrive(uint32_t bar) { emu_mbar_arrive(bar, 0); }

inline void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  emu_mbar_arrive(bar, bytes);
}

// Under emu_mbar_mu (`lock`): yields until ready().  Fails, naming
// `what`, if every running thread of the block has waited here (on an
// mbarrier or setmaxnreg) for a thousand of this fiber's turns with no
// wait of any fiber ending meanwhile, or this wait lasts 2^26 turns
// (threads stuck elsewhere).
template <typename Ready>
inline void emu_block_until(std::unique_lock<std::mutex>& lock, Ready ready,
                            const char* what) {
  std::atomic<int>& blocked = emu_mbar_blocked_pool[emu_cluster_rank];
  ++blocked;
  char msg[160];
  long seen = emu_waits_ended, stuck = 0, turns = 0;
  while (!ready()) {
    lock.unlock();
    emu_yield();
    lock.lock();
    if (blocked.load() < emu_live->load() || emu_waits_ended != seen) {
      stuck = 0;
      seen = emu_waits_ended;
    } else if (++stuck > 1000) {
      snprintf(msg, sizeof msg, "%s: every thread waits on a phase that "
               "cannot complete", what);
      emu_fail(msg);
    }
    if (++turns > (1L << 26)) {
      snprintf(msg, sizeof msg, "%s: a wait of over 2^26 turns", what);
      emu_fail(msg);
    }
  }
  ++emu_waits_ended;
  --blocked;
}

// Blocks until the phase of parity `parity` has completed (the phase
// before the current one, if its parity is `parity`).
inline bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  std::unique_lock<std::mutex> lock(emu_mbar_mu);
  ++emu_mbar_waits;
  emu_block_until(lock, [&] {
    EmuMbar& m = emu_mbar(bar);
    emu_mbar_progress(m, true);
    return (m.phase & 1) != (long)(parity & 1);
  }, "mbarrier");
  return true;
}

// ----------------------------------------------------------- setmaxnreg
// per block (emu_block_key): the registers per thread of each warpgroup,
// the pool, and the setmaxnreg each warpgroup is gathering
struct EmuRegs {
  bool init = false;
  long pool = 0;
  int count[8], target[8], arrived[8];
  bool inc[8];
  long done[8];
};
inline std::map<std::pair<long, long>, EmuRegs> emu_regs;
inline std::atomic<long> emu_setmaxnreg_calls{0};

inline void emu_setmaxnreg(int n, bool inc) {
  if (n % 8 || n < 24 || n > 256)
    emu_fail("setmaxnreg: a count not a multiple of 8 in [24, 256]");
  const int wg = threadIdx.x / 128;
  if (wg >= (int)(blockDim.x / 128) || wg >= 8)
    emu_fail("setmaxnreg: not in a warpgroup");
  std::unique_lock<std::mutex> lock(emu_mbar_mu);
  EmuRegs& r = emu_regs[emu_block_key];
  if (!r.init) {
    r.init = true;
    for (int i = 0; i < 8; ++i) {
      r.count[i] = std::min(255, (int)(65536 / blockDim.x)) / 8 * 8;
      r.target[i] = r.arrived[i] = 0;
      r.done[i] = 0;
    }
  }
  if (inc ? n < r.count[wg] : n > r.count[wg])
    emu_fail("setmaxnreg: an inc below or a dec above the current count");
  if (r.arrived[wg] == 0) {
    r.target[wg] = n;
    r.inc[wg] = inc;
  } else if (r.target[wg] != n || r.inc[wg] != inc) {
    emu_fail("setmaxnreg: the warpgroup's threads issue different ones");
  }
  ++emu_setmaxnreg_calls;
  const long gen = r.done[wg];
  if (++r.arrived[wg] < 128) {
    emu_block_until(lock, [&] { return r.done[wg] != gen; }, "setmaxnreg");
    return;
  }
  // the warpgroup's last thread: dec frees, inc waits for the pool
  const long need = (long)(n - r.count[wg]) * 128;
  if (inc) emu_block_until(lock, [&] { return r.pool >= need; }, "setmaxnreg");
  r.pool -= need;
  r.count[wg] = n;
  r.arrived[wg] = 0;
  ++r.done[wg];
}

template <int N> inline void setmaxnreg_dec() { emu_setmaxnreg(N, false); }
template <int N> inline void setmaxnreg_inc() { emu_setmaxnreg(N, true); }

// ------------------------------------------------------------------ TMA
inline void emu_tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                         const int* coord, int rank) {
  std::lock_guard<std::mutex> lock(emu_mbar_mu);
  if (map->rank != rank) emu_fail("TMA: rank differs from the map's");
  if (dst % 128) emu_fail("TMA: shared address not 128-byte aligned");
  if (map->swizzle && dst % (8 * map->swizzle))
    emu_fail("TMA: swizzled box not on its pattern's boundary");
  EmuTmaCopy c{dst, *map, {}};
  long n = 2;
  for (int d = 0; d < rank; ++d) {
    c.coord[d] = coord[d];
    n *= map->box[d];
  }
  if (dst + n > kEmuSmem) emu_fail("TMA: box past shared memory");
  memset(emu_smem + dst, 0xFF, n);
  emu_mbar(bar).copies.push_back(c);
  ++emu_tma_loads;
}

inline void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                        int c0, int c1, int c2) {
  const int c[3] = {c0, c1, c2};
  emu_tma_load(dst, map, bar, c, 3);
}

inline void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                        int c0, int c1, int c2, int c3) {
  const int c[4] = {c0, c1, c2, c3};
  emu_tma_load(dst, map, bar, c, 4);
}

// ---------------------------------------------------------------- wgmma
// per thread: the accumulators in flight (their value after every wgmma
// issued on them, and the groups not yet retired that use them)
struct EmuAcc {
  std::vector<float> v;
  int groups = 0;
};
inline std::map<float*, EmuAcc> emu_acc;
inline std::vector<float*> emu_wg_open;
inline std::vector<std::vector<float*>> emu_wg_groups;
inline bool emu_fenced = false;

// the wgmma state in flight, per fiber
struct EmuWgState {
  std::map<float*, EmuAcc> acc;
  std::vector<float*> open;
  std::vector<std::vector<float*>> groups;
  bool fenced = false;
};
inline std::vector<EmuWgState> emu_wg_states;
inline void emu_wg_hook(int f, bool) {
  if ((int)emu_wg_states.size() <= f) emu_wg_states.resize(f + 1);
  EmuWgState& w = emu_wg_states[f];
  std::swap(emu_acc, w.acc);
  std::swap(emu_wg_open, w.open);
  std::swap(emu_wg_groups, w.groups);
  std::swap(emu_fenced, w.fenced);
}
inline const bool emu_wg_hooked =
    (emu_fiber_hooks.push_back(emu_wg_hook), true);
inline std::atomic<long> emu_wgmma{0};

inline void wgmma_fence() { emu_fenced = true; }

inline void wgmma_commit() {
  emu_wg_groups.push_back(emu_wg_open);
  emu_wg_open.clear();
  emu_fenced = false;
}

template <int N> inline void wgmma_wait() {
  while ((int)emu_wg_groups.size() > N) {
    for (float* d : emu_wg_groups.front()) {
      EmuAcc& a = emu_acc.at(d);
      if (--a.groups == 0) {
        std::copy(a.v.begin(), a.v.end(), d);
        emu_acc.erase(d);
      }
    }
    emu_wg_groups.erase(emu_wg_groups.begin());
  }
}

// Element (mn, k) of an operand through its descriptor: swizzle S from the
// layout type; transposed ("MN-major", mn contiguous): one atom of S / 2
// elements along mn every LBO bytes, k at (k / 8) SBO + (k % 8) S within
// it; else ("K-major", k contiguous, the 16 k of one instruction within an
// S-byte row): mn at (mn / 8) SBO + (mn % 8) S, k at 2k.  The swizzle
// applies to the absolute address, so a start inside the pattern (a row
// or a 32-byte k step on) reads what TMA wrote there; the kernels' starts
// rely on it, and the card agrees.  Base offset 0 only.
inline float emu_desc_elem(uint64_t desc, int mn, int k, bool mn_major) {
  const uint32_t start = (uint32_t)(desc & 0x3FFF) << 4;
  const uint32_t lbo = (uint32_t)((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3FFF) << 4;
  const int base_off = (int)((desc >> 49) & 7), layout = (int)(desc >> 62);
  const int S = layout == 1 ? 128 : layout == 2 ? 64 : layout == 3 ? 32 : 0;
  if (!S) emu_fail("wgmma: descriptor without a swizzle (not emulated)");
  if (base_off != 0) emu_fail("wgmma: a base offset (not emulated)");
  uint32_t a;
  if (mn_major) {
    const int aw = S / 2;
    a = start + (uint32_t)(mn / aw) * lbo + (uint32_t)(k / 8) * sbo +
        (uint32_t)(k % 8) * S + (uint32_t)(mn % aw) * 2;
  } else {
    if (start % S + 32 > (uint32_t)S)
      emu_fail("wgmma: a K-major k16 step across its swizzle row");
    a = start + (uint32_t)(mn / 8) * sbo + (uint32_t)(mn % 8) * S +
        (uint32_t)k * 2;
  }
  a ^= ((a >> 7) & (uint32_t)(S / 16 - 1)) << 4;
  if (a + 2 > kEmuSmem) emu_fail("wgmma: B past shared memory");
  uint16_t v;
  memcpy(&v, emu_smem + a, 2);
  return __bfloat162float(__nv_bfloat16{v});
}

// an issued product on d: its value in flight, d in the open group, and d
// poisoned until the wait_group that retires its last group
inline void emu_wg_issue(float* d, int n, const std::vector<float>& v) {
  EmuAcc& acc = emu_acc[d];
  acc.v = v;
  if (std::find(emu_wg_open.begin(), emu_wg_open.end(), d) ==
      emu_wg_open.end()) {
    emu_wg_open.push_back(d);
    ++acc.groups;
  }
  for (int i = 0; i < n; ++i) d[i] = NAN;
}

// d += A B for m64nNk16, A from registers (each warp's rows as the
// mma.m16n8k16 A fragment), B [16 x N] through its descriptor, transposed
// (MN-major) or K-major
inline void emu_wgmma_rs(float* d, int N, const uint32_t (&a)[4],
                         uint64_t bdesc, bool mn_major) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int wg = threadIdx.x / 128;
  if (wg >= (int)(blockDim.x / 128)) emu_fail("wgmma: not in a warpgroup");
  if (!emu_fenced && emu_wg_open.empty())
    emu_fail("wgmma: a batch issued without wgmma.fence before it");
  for (int i = 0; i < 4; ++i) emu_xch[w][lane].a[i] = a[i];
  emu_wg_bar[wg]->arrive_and_wait();
  if (threadIdx.x % 128 == 0) ++emu_wgmma;
  auto lo = [](uint32_t v) { return __bfloat162float({(uint16_t)(v & 0xffff)}); };
  auto hi = [](uint32_t v) { return __bfloat162float({(uint16_t)(v >> 16)}); };
  // this warp's rows g and g + 8 of A, from its lanes' fragments
  const int g = lane / 4, t = lane % 4;
  float A[2][16];
  for (int l = 0; l < 32; ++l) {
    if (l / 4 != g) continue;
    const EmuLane& e = emu_xch[w][l];
    const int tt = l % 4;
    A[0][2 * tt] = lo(e.a[0]);     A[0][2 * tt + 1] = hi(e.a[0]);
    A[1][2 * tt] = lo(e.a[1]);     A[1][2 * tt + 1] = hi(e.a[1]);
    A[0][2 * tt + 8] = lo(e.a[2]); A[0][2 * tt + 9] = hi(e.a[2]);
    A[1][2 * tt + 8] = lo(e.a[3]); A[1][2 * tt + 9] = hi(e.a[3]);
  }
  auto it = emu_acc.find(d);
  std::vector<float> v = it != emu_acc.end()
                             ? it->second.v
                             : std::vector<float>(d, d + N / 2);
  for (int j = 0; j < N / 8; ++j)
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * t + e;
      float b[16];
      for (int k = 0; k < 16; ++k)
        b[k] = emu_desc_elem(bdesc, col, k, mn_major);
      for (int h = 0; h < 2; ++h) {
        float s = 0.f;
        for (int k = 0; k < 16; ++k) s += A[h][k] * b[k];
        v[4 * j + 2 * h + e] += s;
      }
    }
  emu_wg_issue(d, N / 2, v);
  emu_wg_bar[wg]->arrive_and_wait();
}

template <int N>
inline void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                     uint64_t bdesc) {
  emu_wgmma_rs(d, N, a, bdesc, true);
}

inline void wgmma_rs128(float (&d)[64], const uint32_t (&a)[4],
                        uint64_t bdesc) {
  emu_wgmma_rs(d, 128, a, bdesc, false);
}

// d += A B for m64n128k16 with both operands through descriptors: A
// [64 x 16] transposed (M contiguous), B [16 x 128] K-major
inline void wgmma_ss128(float (&d)[64], uint64_t adesc, uint64_t bdesc) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  if (threadIdx.x / 128 >= blockDim.x / 128)
    emu_fail("wgmma: not in a warpgroup");
  if (!emu_fenced && emu_wg_open.empty())
    emu_fail("wgmma: a batch issued without wgmma.fence before it");
  if (threadIdx.x % 128 == 0) ++emu_wgmma;
  const int g = lane / 4, t = lane % 4;
  float A[2][16];
  for (int h = 0; h < 2; ++h)
    for (int k = 0; k < 16; ++k)
      A[h][k] = emu_desc_elem(adesc, 16 * w + g + 8 * h, k, true);
  auto it = emu_acc.find(d);
  std::vector<float> v = it != emu_acc.end() ? it->second.v
                                             : std::vector<float>(d, d + 64);
  for (int j = 0; j < 16; ++j)
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * t + e;
      float b[16];
      for (int k = 0; k < 16; ++k) b[k] = emu_desc_elem(bdesc, col, k, false);
      for (int h = 0; h < 2; ++h) {
        float s = 0.f;
        for (int k = 0; k < 16; ++k) s += A[h][k] * b[k];
        v[4 * j + 2 * h + e] += s;
      }
    }
  emu_wg_issue(d, 64, v);
}

// ---------------------------------------------------------------- warps
// stmatrix.x4.trans: lane 8i + r writes row r of matrix i as stored, which
// is column r of matrix i in the registers (row q of it from lane
// 4q + r / 2, the low or high half of its register i)
inline void stmatrix_x4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (addr % 16) emu_fail("stmatrix: row address not 16-byte aligned");
  emu_xch[w][lane].addr = addr;
  for (int i = 0; i < 4; ++i) emu_xch[w][lane].a[i] = r[i];
  emu_warp_sync();
  const int i = lane / 8, col = lane % 8;
  for (int q = 0; q < 8; ++q) {
    const uint32_t v = emu_xch[w][4 * q + col / 2].a[i];
    const uint16_t e = (uint16_t)(col & 1 ? v >> 16 : v & 0xffff);
    memcpy(emu_smem + addr + 2 * q, &e, 2);
  }
  emu_warp_sync();
}

inline void __syncwarp() { emu_warp_sync(); }

}  // namespace smsut
