// Host emulation of the CUDA runtime and device pieces that the port's mma
// kernels use, so that their source compiles with g++ and runs on the CPU:
// one block at a time, one std::thread per CUDA thread, a std::barrier for
// __syncthreads and one per warp for the warp collectives of prims.h.
// Shared memory is one static buffer, filled with a garbage pattern before
// every block so that a read of an unwritten byte shows.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
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
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
template <typename T> inline T __ldg(const T* p) { return *p; }

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
inline float __fmul_rn(float a, float b) { return a * b; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
// a block's shared-memory limit (the H100's 227 KB unless EMU_OPTIN says)
inline int emu_optin = 232448;
inline int emu_smem_attr = 0;
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = emu_optin;
  return cudaSuccess;
}
template <typename K> cudaError_t cudaFuncSetAttribute(K, int, int v) {
  emu_smem_attr = v;
  return v > emu_optin ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

alignas(16) inline unsigned char emu_smem[240 * 1024];
inline uint64_t __cvta_generic_to_shared(const void* p) {
  return (const unsigned char*)p - emu_smem;
}

inline std::barrier<>* emu_block_bar;
inline std::barrier<>* emu_warp_bar[32];
inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }
inline void emu_warp_sync() {
  emu_warp_bar[threadIdx.x / 32]->arrive_and_wait();
}

// kernel<<<grid, threads, smem_bytes, stream>>>(args...)
template <typename Kernel, typename... Args>
void emu_launch(Kernel k, dim3 grid, int threads, size_t smem_bytes,
                cudaStream_t, Args... args) {
  if (smem_bytes > 48 * 1024 && (int)smem_bytes > emu_smem_attr) {
    fprintf(stderr, "launch refused: %zu bytes of shared memory without the "
            "attribute\n", smem_bytes);
    exit(3);
  }
  if (smem_bytes > sizeof(emu_smem)) exit(3);
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        memset(emu_smem, 0xA5, sizeof(emu_smem));
        std::barrier<> block_bar(threads);
        emu_block_bar = &block_bar;
        for (int w = 0; w < threads / 32; ++w)
          emu_warp_bar[w] = new std::barrier<>(32);
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
          ts.emplace_back([=]() {
            threadIdx = {(unsigned)t, 0, 0};
            blockIdx = {bx, by, bz};
            gridDim = grid;
            blockDim = dim3(threads);
            k(args...);
          });
        for (auto& t : ts) t.join();
        for (int w = 0; w < threads / 32; ++w) delete emu_warp_bar[w];
      }
}
