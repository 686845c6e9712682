// K2: 3x3 stride-1 SAME convolution forward, NHWC, float32 or bfloat16,
// float32 accumulation, output in the input's type.
//
// Replaces the TPU kernel smsut_tpu/ops/conv_pallas.py `_conv_fwd` (kernel
// `_fwd_kernel`; public `conv_same_pallas`), which builds an im2col strip
// [strip*W, 9C] in VMEM and runs one MXU dot per strip.
//
// Bound on the H100: operations.  At the U-Net's shapes the conv does
// 2*9*Cin*Cout operations per output pixel, from 144 (Cin 8, Cout 16) to
// over a million, against (Cin + Cout) * 2 bytes moved per pixel: well
// above the card's ~295 operations per byte for every conv of the path
// except the narrowest.  The bound is the tensor cores' bf16 rate.
//
// Two paths, chosen by dtype alone:
// - bfloat16, the path of training and serving: the tensor-core kernel of
//   conv3x3_tc.cuh (mma.sync.m16n8k16, float32 accumulators, one rounding
//   at the store).  It takes every shape this entry point takes; where it
//   refuses one (a weight that is not 16-byte aligned, a device with too
//   little shared memory) the call returns cudaErrorInvalidValue and runs
//   nothing: there is no fallback to the CUDA-core kernel.
// - float32, the parity path (every float32 check runs with TF32 off): the
//   CUDA-core tile of conv_tile.cuh, float32 FMAs, exact float32 products.
// Any H, W and Cin; Cout must be a multiple of 8 (the wrapper raises
// otherwise): Cout 8 is the dx of the U-Net's first block, whose input has
// 8 channels at width 16.
#include "conv_tile.cuh"
#include "conv3x3_tc.cuh"

using namespace smsut;

// x [B][H][W][Cin], w [3][3][Cin][Cout], y [B][H][W][Cout], same dtype.
extern "C" int smsut_conv3x3_fwd(const void* x, const void* w, void* y, int B,
                                 int H, int W, int Cin, int Cout, int dtype,
                                 void* stream) {
  if (Cout % 8 != 0 || Cin < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_conv<float, 3, false, false>(
        (const float*)x, (const float*)w, (float*)y, nullptr, nullptr, B, H,
        W, Cin, Cout, s);
  if (dtype == 1)
    return (int)conv3x3_tc((const bf16*)x, (const bf16*)w, (bf16*)y, B, H, W,
                           Cin, Cout, s);
  return (int)cudaErrorInvalidValue;
}
