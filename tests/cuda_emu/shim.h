// Host emulation of the CUDA runtime and device pieces that the port's
// kernels use, so that their source compiles with g++ and runs on the CPU:
// one fiber per CUDA thread, a barrier for __syncthreads and one per warp
// for the warp collectives of prims.h.  Blocks run one at a time,
// except the blocks of one thread-block cluster (cudaLaunchKernelEx with a
// cluster dimension), which run at once, meet at cluster.sync() and read
// each other's shared memory (cooperative_groups.h).  Each block's shared
// memory is its own buffer, 1024-byte aligned, filled with a garbage
// pattern before the block so that a read of an unwritten byte shows.  The
// launcher also keeps a barrier per full warpgroup of 128 threads (wgmma,
// sm90_prims.h), the count of each block's threads still running (the
// mbarrier emulation's deadlock check) and a key per block run
// (setmaxnreg's register pool).
//
// The fibers (ucontext) of a launch take turns on the launching thread,
// each running until it waits (a barrier, an mbarrier, setmaxnreg) or
// ends, and the per-thread state of the headers is saved and restored at
// each switch (emu_fiber_hooks).  (With an operating-system thread per
// CUDA thread, every barrier woke several hundred threads, which cost most
// of the emulation's time, and more on a loaded host.)
#pragma once
#include <algorithm>
#include <sys/mman.h>
#include <ucontext.h>

#include <atomic>
#include <functional>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <utility>
#include <vector>
using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_uint3 { unsigned x, y, z; };
inline emu_uint3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;

struct uint4 { uint32_t x, y, z, w; };
struct uint2 { uint32_t x, y; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
template <typename T> inline T __ldg(const T* p) { return *p; }
template <typename T> inline T __ldcg(const T* p) { return *p; }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}

struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 v) {
  uint32_t u = (uint32_t)v.x << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  uint32_t u;
  memcpy(&u, &f, 4);
  u += 0x7fff + ((u >> 16) & 1);
  return __nv_bfloat16{(uint16_t)(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
// float32 arithmetic rounded once per operation (no contraction into an
// FMA), as the device intrinsics give it
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __low2float(__nv_bfloat162 v) { return __bfloat162float(v.x); }
inline float __high2float(__nv_bfloat162 v) { return __bfloat162float(v.y); }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaFuncAttributeNonPortableClusterSizeAllowed = 9 };
enum { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97,
       cudaDevAttrMultiProcessorCount = 16 };
// a block's shared-memory limit (the H100's 227 KB unless EMU_OPTIN says)
inline int emu_optin = 232448;
inline int emu_smem_attr = 0;
// clusters that may run at once (the occupancy query's answer), and
// whether clusters over 8 blocks were allowed
inline int emu_max_clusters = 1 << 30;
inline bool emu_nonportable = false;
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
// the device's SMs (the H100's 132 unless EMU_SMS says)
inline int emu_sms = 132;
inline cudaError_t cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMultiProcessorCount ? emu_sms : emu_optin;
  return cudaSuccess;
}
template <typename K> cudaError_t cudaFuncSetAttribute(K, int attr, int v) {
  if (attr == cudaFuncAttributeNonPortableClusterSizeAllowed) {
    emu_nonportable = v != 0;
    return cudaSuccess;
  }
  emu_smem_attr = v;
  return v > emu_optin ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// ---- fibers: a launch's CUDA threads take turns on the launching thread

// state a header keeps per CUDA thread, handed between the
// globals and fiber f's own copy: hook(f, true) before f runs, hook(f,
// false) after it yields
inline std::vector<void (*)(int, bool)> emu_fiber_hooks;
inline int emu_fiber = -1;   // the running fiber, -1 for the launcher
inline ucontext_t emu_sched_ctx;
struct EmuFiber {
  ucontext_t ctx;
  bool done;
};
inline std::vector<EmuFiber> emu_fibers;
inline std::vector<void*> emu_stacks;   // kept for the next launches
constexpr size_t kEmuStack = 256 * 1024;
inline std::function<void(int)>* emu_fiber_fn;

inline void emu_yield() {
  swapcontext(&emu_fibers[emu_fiber].ctx, &emu_sched_ctx);
}

inline void emu_fiber_entry() {
  (*emu_fiber_fn)(emu_fiber);
  emu_fibers[emu_fiber].done = true;
}

// fn(0) .. fn(count - 1), each a fiber, in turns: fiber f runs from where
// it yielded until it yields again or ends
inline void emu_run_fibers(int count, std::function<void(int)> fn) {
  while ((int)emu_stacks.size() < count) {
    void* st = mmap(nullptr, kEmuStack, PROT_READ | PROT_WRITE,
                    MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (st == MAP_FAILED) {
      fprintf(stderr, "fibers: no memory for a stack\n");
      exit(3);
    }
    emu_stacks.push_back(st);
  }
  emu_fiber_fn = &fn;
  emu_fibers.assign(count, EmuFiber{});
  for (int f = 0; f < count; ++f) {
    EmuFiber& fb = emu_fibers[f];
    getcontext(&fb.ctx);
    fb.ctx.uc_stack.ss_sp = emu_stacks[f];
    fb.ctx.uc_stack.ss_size = kEmuStack;
    fb.ctx.uc_link = &emu_sched_ctx;
    makecontext(&fb.ctx, emu_fiber_entry, 0);
  }
  for (int live = count; live;)
    for (int f = 0; f < count; ++f) {
      if (emu_fibers[f].done) continue;
      for (auto h : emu_fiber_hooks) h(f, true);
      emu_fiber = f;
      swapcontext(&emu_sched_ctx, &emu_fibers[f].ctx);
      emu_fiber = -1;
      for (auto h : emu_fiber_hooks) h(f, false);
      live -= emu_fibers[f].done;
    }
}

// The threads of a block, a warp, a warpgroup or a cluster meet in
// arrive_and_wait(): a fiber that is not the last to arrive yields until
// the last one advances the phase.  A wait that outlasts every other
// fiber's many turns cannot complete.
class EmuBarrier {
 public:
  explicit EmuBarrier(int n) : n_(n) {}
  void arrive_and_wait() {
    const unsigned ph = phase_;
    if (++count_ == n_) {
      count_ = 0;
      ++phase_;
      return;
    }
    for (long turns = 0; phase_ == ph; ++turns) {
      if (turns > (1L << 24)) {
        fprintf(stderr, "barrier: a wait that cannot complete\n");
        exit(5);
      }
      emu_yield();
    }
  }

 private:
  unsigned phase_ = 0;
  int count_ = 0;
  const int n_;
};

// the per-block state of a running block: its shared memory, its
// barriers, and the exchange slots of its warps' collectives (prims.h)
struct EmuLane { uint32_t addr; uint32_t a[4]; uint32_t b[2]; float f; };
constexpr int kEmuMaxCluster = 16;
constexpr size_t kEmuSmem = 240 * 1024;
alignas(1024) inline unsigned char emu_smem_pool[kEmuMaxCluster][kEmuSmem];
inline EmuLane emu_xch_pool[kEmuMaxCluster][32][32];
inline unsigned char* emu_smem;
inline EmuLane (*emu_xch)[32];
inline EmuBarrier* emu_block_bar;
inline EmuBarrier** emu_warp_bar;
inline EmuBarrier** emu_wg_bar;
inline std::atomic<int> emu_live_pool[kEmuMaxCluster];
inline std::atomic<int>* emu_live;
inline int emu_cluster_rank = 0, emu_cluster_size = 1;
// the running block's key, new for every block of every launch: (launch,
// block index within it)
inline std::pair<long, long> emu_block_key;
inline std::atomic<long> emu_launch_count{0};
inline EmuBarrier* emu_cluster_bar;

// this header's per-thread state, per fiber
struct EmuShimState {
  emu_uint3 tid, bid;
  dim3 gdim, bdim;
  unsigned char* smem;
  EmuLane (*xch)[32];
  EmuBarrier *block_bar, **warp_bar, **wg_bar, *cluster_bar;
  std::atomic<int>* live;
  int crank, csize;
  std::pair<long, long> key;
};
inline std::vector<EmuShimState> emu_shim_states;
inline void emu_shim_hook(int f, bool in) {
  if ((int)emu_shim_states.size() <= f) emu_shim_states.resize(f + 1);
  EmuShimState& s = emu_shim_states[f];
  if (in) {
    threadIdx = s.tid, blockIdx = s.bid, gridDim = s.gdim, blockDim = s.bdim;
    emu_smem = s.smem, emu_xch = s.xch, emu_block_bar = s.block_bar;
    emu_warp_bar = s.warp_bar, emu_wg_bar = s.wg_bar;
    emu_cluster_bar = s.cluster_bar, emu_live = s.live;
    emu_cluster_rank = s.crank, emu_cluster_size = s.csize;
    emu_block_key = s.key;
  } else {
    s = EmuShimState{threadIdx, blockIdx, gridDim, blockDim, emu_smem,
                     emu_xch, emu_block_bar, emu_warp_bar, emu_wg_bar,
                     emu_cluster_bar, emu_live, emu_cluster_rank,
                     emu_cluster_size, emu_block_key};
  }
}
inline const bool emu_shim_hooked =
    (emu_fiber_hooks.push_back(emu_shim_hook), true);
inline uint64_t __cvta_generic_to_shared(const void* p) {
  return (const unsigned char*)p - emu_smem;
}
inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }
inline void emu_warp_sync() {
  emu_warp_bar[threadIdx.x / 32]->arrive_and_wait();
}

// kernel<<<grid, threads, smem_bytes, stream>>>(args...), in clusters of
// `cluster` blocks along x.  One thread of execution per thread of one cluster
// runs the clusters one after another, in grid order; thread 0 of each
// block fills the block's shared memory with the garbage pattern before the
// block starts.
template <typename Kernel, typename... Args>
void emu_launch_clusters(Kernel k, dim3 grid, int threads, size_t smem_bytes,
                         int cluster, Args... args) {
  if (smem_bytes > 48 * 1024 && (int)smem_bytes > emu_smem_attr) {
    fprintf(stderr, "launch refused: %zu bytes of shared memory without the "
            "attribute\n", smem_bytes);
    exit(3);
  }
  if (smem_bytes > kEmuSmem || cluster < 1 || cluster > kEmuMaxCluster ||
      grid.x % cluster || (cluster > 8 && !emu_nonportable)) {
    fprintf(stderr, "launch refused: %zu bytes, cluster %d\n", smem_bytes,
            cluster);
    exit(3);
  }
  const int n = cluster;
  const long launch = ++emu_launch_count;
  const unsigned per_row = grid.x / n;
  const unsigned clusters = per_row * grid.y * grid.z;
  const size_t fill = std::min(kEmuSmem, (smem_bytes + 15) / 16 * 16);
  EmuBarrier cluster_bar(n * threads);
  std::vector<EmuBarrier*> bars;
  std::vector<std::vector<EmuBarrier*>> warps(n), wgs(n);
  for (int r = 0; r < n; ++r) {
    bars.push_back(new EmuBarrier(threads));
    for (int w = 0; w < threads / 32; ++w)
      warps[r].push_back(new EmuBarrier(32));
    for (int w = 0; w < threads / 128; ++w)
      wgs[r].push_back(new EmuBarrier(128));
  }
  // thread t of block r of every cluster, in turn
  auto body = [=, &cluster_bar, &bars, &warps, &wgs](int r, int t) {
        threadIdx = {(unsigned)t, 0, 0};
        gridDim = grid;
        blockDim = dim3(threads);
        emu_smem = emu_smem_pool[r];
        emu_xch = emu_xch_pool[r];
        emu_block_bar = bars[r];
        emu_warp_bar = warps[r].data();
        emu_wg_bar = wgs[r].data();
        emu_live = &emu_live_pool[r];
        emu_cluster_rank = r;
        emu_cluster_size = n;
        emu_cluster_bar = &cluster_bar;
        for (unsigned q = 0; q < clusters; ++q) {
          if (t == 0) {
            memset(emu_smem, 0xA5, fill);
            emu_live->store(threads);
          }
          // the previous cluster has ended and the memory is filled
          cluster_bar.arrive_and_wait();
          blockIdx = {q % per_row * n + r, q / per_row % grid.y,
                      q / per_row / grid.y};
          emu_block_key = {launch, (long)q * n + r};
          k(args...);
          emu_live->fetch_sub(1);
          cluster_bar.arrive_and_wait();
        }
  };
  emu_run_fibers(n * threads,
                 [&](int f) { body(f / threads, f % threads); });
  for (int r = 0; r < n; ++r) {
    delete bars[r];
    for (auto* w : warps[r]) delete w;
    for (auto* w : wgs[r]) delete w;
  }
}

template <typename Kernel, typename... Args>
void emu_launch(Kernel k, dim3 grid, int threads, size_t smem_bytes,
                cudaStream_t, Args... args) {
  emu_launch_clusters(k, grid, threads, smem_bytes, 1, args...);
}

// cudaLaunchKernelEx with its one attribute, the cluster dimension
enum { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  int id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <typename... KArgs, typename... Args>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*k)(KArgs...), Args... args) {
  int cluster = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cluster = cfg->attrs[i].val.clusterDim.x;
  emu_launch_clusters(k, cfg->gridDim, cfg->blockDim.x, cfg->dynamicSmemBytes,
                      cluster, KArgs(args)...);
  return cudaSuccess;
}
inline cudaError_t cudaOccupancyMaxActiveClusters(int* n, const void*,
                                                  const cudaLaunchConfig_t*) {
  *n = emu_max_clusters;
  return cudaSuccess;
}
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, const void*, int, size_t) {
  *n = emu_max_clusters / 132 + 1;
  return cudaSuccess;
}
