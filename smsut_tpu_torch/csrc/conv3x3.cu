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
// Design (conv_tile.cuh): an implicit GEMM done directly, block tile =
// output pixels x output channels, the halo input tile and the weight
// slice staged in shared memory per 16-channel chunk of Cin, register
// tiles of 4 pixels x 4 channels, float32 FMAs on the CUDA cores.  This
// first version stays far from the bound (it runs on the CUDA cores, not
// the tensor cores); mma.sync/wgmma with TMA staging is the next step.
// Any H, W and Cin; Cout must be a multiple of 8 (the wrapper raises
// otherwise): the 8-channel tile (32x16 pixels) serves the dx of the
// U-Net's first block, whose input has 8 channels at width 16.
#include "conv_tile.cuh"

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
    return (int)launch_conv<__nv_bfloat16, 3, false, false>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)y,
        nullptr, nullptr, B, H, W, Cin, Cout, s);
  return (int)cudaErrorInvalidValue;
}
