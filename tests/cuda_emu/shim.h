// Host emulation of the CUDA runtime and device pieces that the port's
// kernels use, so that their source compiles with g++ and runs on the CPU:
// one std::thread per CUDA thread, a std::barrier for __syncthreads and one
// per warp for the warp collectives of prims.h.  Blocks run one at a time,
// except the blocks of one thread-block cluster (cudaLaunchKernelEx with a
// cluster dimension), which run at once, meet at cluster.sync() and read
// each other's shared memory (cooperative_groups.h).  Each block's shared
// memory is its own buffer, 1024-byte aligned, filled with a garbage
// pattern before the block so that a read of an unwritten byte shows.  The
// launcher also keeps a barrier per full warpgroup of 128 threads (wgmma,
// sm90_prims.h), the count of each block's threads still running (the
// mbarrier emulation's deadlock check) and a key per block run
// (setmaxnreg's register pool).
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
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
inline thread_local emu_uint3 threadIdx, blockIdx;
inline thread_local dim3 gridDim, blockDim;

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

// the per-block state of a running block: its shared memory, its
// barriers, and the exchange slots of its warps' collectives (prims.h)
struct EmuLane { uint32_t addr; uint32_t a[4]; uint32_t b[2]; float f; };
constexpr int kEmuMaxCluster = 16;
constexpr size_t kEmuSmem = 240 * 1024;
alignas(1024) inline unsigned char emu_smem_pool[kEmuMaxCluster][kEmuSmem];
inline EmuLane emu_xch_pool[kEmuMaxCluster][32][32];
inline thread_local unsigned char* emu_smem;
inline thread_local EmuLane (*emu_xch)[32];
inline thread_local std::barrier<>* emu_block_bar;
inline thread_local std::barrier<>** emu_warp_bar;
inline thread_local std::barrier<>** emu_wg_bar;
inline std::atomic<int> emu_live_pool[kEmuMaxCluster];
inline thread_local std::atomic<int>* emu_live;
inline thread_local int emu_cluster_rank = 0, emu_cluster_size = 1;
// the running block's key, new for every block of every launch: (launch,
// block index within it)
inline thread_local std::pair<long, long> emu_block_key;
inline std::atomic<long> emu_launch_count{0};
inline thread_local std::barrier<>* emu_cluster_bar;
inline uint64_t __cvta_generic_to_shared(const void* p) {
  return (const unsigned char*)p - emu_smem;
}
inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }
inline void emu_warp_sync() {
  emu_warp_bar[threadIdx.x / 32]->arrive_and_wait();
}

// kernel<<<grid, threads, smem_bytes, stream>>>(args...), in clusters of
// `cluster` blocks along x.  One std::thread per thread of one cluster
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
  std::barrier<> cluster_bar(n * threads);
  std::vector<std::barrier<>*> bars;
  std::vector<std::vector<std::barrier<>*>> warps(n), wgs(n);
  for (int r = 0; r < n; ++r) {
    bars.push_back(new std::barrier<>(threads));
    for (int w = 0; w < threads / 32; ++w)
      warps[r].push_back(new std::barrier<>(32));
    for (int w = 0; w < threads / 128; ++w)
      wgs[r].push_back(new std::barrier<>(128));
  }
  std::vector<std::thread> ts;
  for (int r = 0; r < n; ++r)
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([=, &cluster_bar, &bars, &warps, &wgs]() {
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
      });
  for (auto& t : ts) t.join();
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
