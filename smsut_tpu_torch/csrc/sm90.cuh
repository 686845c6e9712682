// Hopper (sm_90a) pieces of the port's kernels, as small inline functions
// over hand-written PTX: mbarriers, TMA tiled loads that complete on an
// mbarrier, warpgroup matrix products (wgmma) with their operands in
// shared memory read through matrix descriptors, or A in registers, and
// setmaxnreg, which moves registers between warpgroups.
// Beside them, the descriptor's bits and the host side of TMA (a tensor
// map encoded by the CUDA driver's cuTensorMapEncodeTiled, reached through the
// runtime's entry point into it, so that no library links against libcuda).
//
// Layouts (PTX ISA 8.x, "Tensor copy" and "Asynchronous warpgroup level
// matrix multiply"):
//   - A TMA box lands in shared memory densely, innermost dimension first.
//     With a swizzle of S bytes (32, 64 or 128) and a box whose inner
//     dimension is S bytes, the 16-byte chunk c of the box row at byte
//     address a goes to chunk c ^ ((a >> 7) & (S / 16 - 1)).  Every
//     destination here starts on a 1024-byte boundary, where the patterns
//     of all three swizzles begin.
//   - An operand through a descriptor with a swizzle of S bytes, its
//     element (mn, k): transposed ("MN-major", mn contiguous, one atom of
//     S / 2 elements along mn) at start + (k / 8) SBO + (k % 8) S + 2 mn;
//     K-major (k contiguous) at start + (mn / 8) SBO + (mn % 8) S + 2 k.
//     The swizzle applies to the absolute address, so a start moved into
//     the pattern (by whole S-byte rows, or 32 bytes along a K-major row
//     for the next k16 step) reads what TMA wrote there.  LBO, the stride
//     between atoms along mn, is not read when mn spans one atom.
//   - The accumulator of warp w of the warpgroup is rows 16w + g and
//     16w + g + 8 (g = lane / 4); register 4j + 2h + e holds column
//     8j + 2(lane % 4) + e of row 16w + g + 8h.  With A in registers, warp
//     w holds rows 16w .. 16w + 15 of A as mma.m16n8k16's A fragment
//     (mma_tile.cuh).
//
// The CPU emulation (tests/cuda_emu/sm90_prims.h) stands in for the part
// between the two PTX markers and for <cuda.h>; the rest compiles as it is
// on both.
#pragma once

#include <cuda.h>

#include "mma_tile.cuh"

namespace smsut {

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :
               : "r"(bar), "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :
               : "r"(bar)
               : "memory");
}

// arrive, and expect `bytes` more of transactions (TMA copies) in the
// barrier's current phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :
               : "r"(bar), "r"(bytes)
               : "memory");
}

// whether the phase of parity `parity` has completed
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// TMA: the box of `map` at coordinates (innermost first) into shared
// memory at dst; the copy's bytes complete on the barrier at bar
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :
      : "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :
      : "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// orders the registers written before it (A fragments, accumulators)
// before the wgmma that follow
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups are in flight
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += A B: wgmma.m64nNk16, bf16 operands, float32 accumulators; A is the
// warp's m16k16 fragment in registers, B [16 x N] transposed through the
// descriptor bdesc (scale-d true: accumulate; A and B unscaled; B
// transposed).  Issued by all 128 threads of the warpgroup.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t bdesc) {
  static_assert(N == 16 || N == 32 || N == 64, "N of 16, 32 or 64");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(1));
  }
}

// d += A B: wgmma.m64n128k16, bf16 operands, float32 accumulators; A
// [64 x 16] through adesc, transposed (M contiguous), B [16 x 128] through
// bdesc, not transposed (K contiguous).  Issued by all 128 threads of the
// warpgroup.
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t adesc,
                                            uint64_t bdesc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(adesc), "l"(bdesc), "r"(1));
}

// d += A B: wgmma.m64n128k16, bf16 operands, float32 accumulators; A is
// the warp's m16k16 fragment in registers, B [16 x 128] through bdesc, not
// transposed (K contiguous), as wgmma_ss128 reads it.  Issued by all 128
// threads of the warpgroup.
__device__ __forceinline__ void wgmma_rs128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t bdesc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(1));
}

// The warpgroup's registers per thread, lowered to N (the producer's) or
// raised to N (the consumers', which waits until the lowered ones are
// free); N a multiple of 8 in [24, 256].  All four warps of the warpgroup
// issue it.  ptxas honours it only where every warpgroup's path from the
// kernel's entry is plain (one if/else by role that never reconverges).
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  static_assert(N % 8 == 0 && N >= 24 && N <= 256, "N of 24-256, by 8");
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  static_assert(N % 8 == 0 && N >= 24 && N <= 256, "N of 24-256, by 8");
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices from registers to shared memory, transposed:
// register i holds, as ldmatrix's, row l / 4, elements 2(l % 4) and
// 2(l % 4) + 1 of matrix i; lanes 8i .. 8i+7 give the 16-byte aligned
// addresses of the rows of matrix i as stored, row r being its column r.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr,
                                                  const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
      "{%1, %2, %3, %4};\n"
      :
      : "r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}
// ------------------------------------------------------------ end of PTX

// wait until the phase of parity `parity` of the barrier at bar completes
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), base offset 0, and the swizzle of
// S bytes (layout type 1: 128, 2: 64, 3: 32)
__host__ __device__ constexpr uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                                  uint32_t sbo, int S) {
  const uint64_t layout = S == 128 ? 1 : S == 64 ? 2 : S == 32 ? 3 : 0;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

// ---------------------------------------------------------------- host
// the device's SMs (kSMs where unread): a persistent grid's size
inline int sm_count() {
  int dev = 0, v = 0;
  return cudaGetDevice(&dev) == cudaSuccess &&
                 cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount,
                                        dev) == cudaSuccess && v > 0
             ? v
             : kSMs;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of CUDA 12.0, from the CUDA driver through the runtime
// (CUDA 12.5 or later; resolved once); null where the CUDA driver does not give
// it
inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor map of `rank` dimensions over base: dims (innermost
// first), the byte strides of dimensions 1 .. rank-1, the box, the swizzle
// of S bytes (0, 32, 64, 128), zeros read outside the tensor.  False where
// the CUDA driver refuses it (an address not 16-byte aligned, a stride not a
// multiple of 16, a box over 256 or wider than the swizzle).
inline bool bf16_tile_map(CUtensorMap* map, const void* base, int rank,
                          const cuuint64_t* dims, const cuuint64_t* strides,
                          const cuuint32_t* box, int S) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (!encode) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle sw =
      S == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : S == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
      : S == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                : CU_TENSOR_MAP_SWIZZLE_NONE;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                const_cast<void*>(base), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace smsut
