// Tensor-core pieces of the port's mma kernels (conv3x3_mma.cu, and K2's
// and K5's bfloat16 paths, conv3x3_tc.cuh and conv3x3_dw_tc.cuh): bfloat16
// mma.sync.m16n8k16 products with float32 accumulators, their operands fed
// from shared memory by ldmatrix, cp.async copies from device memory into
// shared memory, the staging of a halo'd input tile, and the opt-in to
// more than 48 KB of shared memory.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16 operands), for lane l,
// g = l / 4, t = l % 4, each register holding two consecutive elements:
//   A [16 x 16], row-major:  a0 (row g, k 2t..2t+1),  a1 (row g+8, k 2t..),
//                            a2 (row g, k 2t+8..),    a3 (row g+8, k 2t+8..)
//   B [16 x 8]:              b0 (k 2t..2t+1, col g),  b1 (k 2t+8.., col g)
//   C [16 x 8], float32:     c0, c1 (row g, col 2t, 2t+1),
//                            c2, c3 (row g+8, col 2t, 2t+1)
// ldmatrix.x4 loads four 8x8 bf16 matrices; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i of lane l receives row l/4,
// elements 2(l%4), 2(l%4)+1 of matrix i (with .trans: column l/4, rows
// 2(l%4), 2(l%4)+1), which is exactly the A and B fragments above when the
// lane addresses follow a_lane_addr and b_lane_addr.
//
// Operands in shared memory are row-major with a row stride of an odd
// number of 16-byte chunks (n + 8 elements for n a multiple of 16), so that
// the eight row addresses of one 8x8 matrix fall on eight distinct groups
// of four banks.
#pragma once

#include <mutex>
#include <set>
#include <utility>

#include "common.cuh"

namespace smsut {

typedef __nv_bfloat16 bf16;

// the H100's SMs: the grid a kernel's plan aims to cover
constexpr int kSMs = 132;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// two 8x8 matrices, transposed: lanes 0-7 and 8-15 give the row addresses
// (those of lanes 16-31 are not read); the B fragment of one n8 tile
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t r[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}

// d += A B for one m16n8k16 tile
__device__ __forceinline__ void mma_16816(float d[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from device memory to shared memory, asynchronously; with
// valid false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// lane's ldmatrix address of the 16 x 16 A tile at `base` (row stride ld
// elements): row l % 16, column 8 * (l / 16)
__device__ __forceinline__ uint32_t a_lane_addr(const bf16* base, int ld,
                                                int lane) {
  return smem_addr(base + (lane & 15) * ld + ((lane >> 4) << 3));
}

// lane's ldmatrix.trans address of the 16 x 16 block of B [k][n] at `base`
// (row stride ld elements): row (l % 8) + 8 ((l / 8) % 2), column 8 (l / 16)
__device__ __forceinline__ uint32_t b_lane_addr(const bf16* base, int ld,
                                                int lane) {
  return smem_addr(base + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld +
                   ((lane >> 4) << 3));
}

// acc[NT] += A[16 x 16] B[16 x 8 NT] for one k16 step: a is the lane's
// A address, b its B address at the warp's first column.  One ldmatrix
// for A, one ldmatrix.trans per 16 columns of B, two mma per 16 columns.
template <int NT>
__device__ __forceinline__ void mma_k16(float (&acc)[NT][4], uint32_t a,
                                        uint32_t b) {
  static_assert(NT % 2 == 0, "B is loaded 16 columns at a time");
  uint32_t af[4];
  ldmatrix_x4(af, a);
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    uint32_t bfr[4];
    ldmatrix_x4_trans(bfr, b + j * 32);
    mma_16816(acc[2 * j], af, bfr[0], bfr[1]);
    mma_16816(acc[2 * j + 1], af, bfr[2], bfr[3]);
  }
}

// two float32 values, rounded once to bf16, to p (4-byte aligned)
__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The row stride, in elements, of a staged operand whose rows hold n
// (a multiple of 8) bf16 values: an odd number of 16-byte chunks, so that
// eight consecutive rows fall on eight distinct groups of four banks.
__host__ __device__ constexpr int padded_row(int n) {
  return (n / 8) % 2 ? n : n + 8;
}

// Stage a halo tile of the image xb [H][W][C] into x_s: `rows` image rows
// from r0 - R and kHaloW columns from c0 - R (R = 1 for a 3x3 kernel, 0
// for a 1x1), channels k0 .. k0 + KC - 1 (KC a multiple of 8), pixel p of
// the tile (row-major) at x_s + p * PS.  Zero outside the image and at
// channels >= C.  With vec (C % 8 == 0 and xb 16-byte aligned) by
// cp.async, one 16-byte piece per thread and step; otherwise a pixel's
// channels are not 16-byte aligned, and the pieces are built from element
// loads and stored directly.  Called by every thread of the block.
template <int kHaloW, int R = 1>
__device__ __forceinline__ void stage_halo_bf16(bf16* x_s, const bf16* xb,
                                                int r0, int c0, int rows,
                                                int k0, int KC, int PS, int H,
                                                int W, int C, bool vec) {
  const int kch = KC / 8, n = rows * kHaloW * kch;
  const unsigned short* xe = reinterpret_cast<const unsigned short*>(xb);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int q = i % kch, p = i / kch;
    const int r = r0 - R + p / kHaloW, c = c0 - R + p % kHaloW;
    const int ch = k0 + q * 8;
    const bool in = r >= 0 && r < H && c >= 0 && c < W;
    const size_t off = in ? ((size_t)r * W + c) * C + ch : 0;
    bf16* dst = x_s + p * PS + q * 8;
    if (vec) {
      cp_async16(smem_addr(dst), xb + off, in && ch < C);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t lo = in && ch + 2 * e < C ? xe[off + 2 * e] : 0;
        const uint32_t hi = in && ch + 2 * e + 1 < C ? xe[off + 2 * e + 1] : 0;
        v[e] = lo | hi << 16;
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The PRO step of a halo tile that stage_halo_bf16 staged from a stored
// conv output y (same arguments): each value v of a pixel inside the image
// at a channel < C becomes the normalised activation
// norm_act<bf16>(v, gh[ch], gh[C + ch]) in place, so that the activation
// never reaches device memory.  The padding (outside the image, channels
// >= C) stays 0: it pads the normalised map.  Each thread rewrites the
// pieces it staged itself (the same loop), so after the wait for its own
// copies it needs no barrier; the copies of the next stage stay in flight.
template <int kHaloW, int R = 1>
__device__ __forceinline__ void pro_halo_bf16(bf16* x_s,
                                              const float* __restrict__ gh,
                                              int r0, int c0, int rows,
                                              int k0, int KC, int PS, int H,
                                              int W, int C) {
  const int kch = KC / 8, n = rows * kHaloW * kch;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int q = i % kch, p = i / kch;
    const int r = r0 - R + p / kHaloW, c = c0 - R + p % kHaloW;
    const int ch = k0 + q * 8;
    if (r < 0 || r >= H || c < 0 || c >= W || ch >= C) continue;
    uint4* dst = reinterpret_cast<uint4*>(x_s + p * PS + q * 8);
    uint4 raw = *dst;
    bf16 v[8];
    memcpy(v, &raw, 16);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (ch + e < C)
        v[e] = from_f<bf16>(norm_act<bf16>(to_f(v[e]), gh[ch + e],
                                           gh[C + ch + e]));
    memcpy(&raw, v, 16);
    *dst = raw;
  }
}

// the device's opt-in limit of shared memory per block; 0 if unread
inline size_t smem_optin_bytes() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return (size_t)v;
}

// Raises `kernel`'s limit of dynamic shared memory to the device's opt-in
// maximum, once per (kernel, device).  The set of those done is keyed by
// the address that is then launched: two libraries that hold the same
// template instantiation each have their own kernel and their own address,
// so each opts in its own, however they are built and loaded (and where
// the loader binds both to one copy, that copy is the one launched).
inline cudaError_t opt_in(const void* kernel) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({kernel, dev})) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_optin_bytes());
  if (e == cudaSuccess) done.insert({kernel, dev});
  return e;
}

// Launches kernel<<<grid, threads, smem, s>>>(args...) and returns the
// launch's error.  Over 48 KB a kernel must be allowed its shared memory:
// opt_in does that the first time the kernel runs on a device.
template <typename Kernel, typename... Args>
cudaError_t launch_opted(Kernel kernel, dim3 grid, int threads, size_t smem,
                         cudaStream_t s, Args... args) {
  const cudaError_t e = opt_in(reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

}  // namespace smsut
