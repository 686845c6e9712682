// K5: weight gradient of the 3x3 stride-1 SAME convolution, NHWC, float32
// or bfloat16 inputs, float32 result.
//
//   dw[u][v][ci][co] = sum_{b,i,j} x[b, i+u-1, j+v-1, ci] * g[b,i,j,co]
//
// Replaces the TPU kernel smsut_tpu/ops/conv_pallas.py `_conv_dw` (kernel
// `_dw_kernel`), which builds the same per-strip im2col block as the
// forward and contracts it against the cotangent, accumulating over the
// batch grid into one revisited output block.  (dx is K2 itself, run on the
// cotangent with the flipped, IO-transposed kernel: ops/conv3x3.py.)
//
// Bound on the H100: operations.  2*9*Cin*Cout operations per pixel
// against (Cin + Cout) element reads per pixel, as in the forward.
//
// On the TPU the batch grid runs in order and one output block
// accumulates; on the card blocks run in parallel, so both paths split the
// B*H*W pixels across blocks that each write a float32 partial dw, and a
// second kernel adds the partials in a fixed order (no atomics: runs agree
// bit for bit).  Two paths, chosen by dtype alone:
// - bfloat16, the path of training: the tensor-core kernel of
//   conv3x3_dw_tc.cuh (mma.sync, one 16 x 16 channel unit per warp for all
//   nine taps).  A shape it refuses returns cudaErrorInvalidValue and runs
//   nothing: there is no fallback;
// - float32, the parity path: conv_dw.cuh, float32 FMAs on the CUDA cores.
// Any H, W and Cin; Cout must be a multiple of 16.
#include "conv_dw.cuh"
#include "conv3x3_dw_tc.cuh"

using namespace smsut;

// float32 elements of the scratch smsut_conv3x3_dw needs (either path)
extern "C" long long smsut_conv3x3_dw_scratch(int B, int H, int W, int Cin,
                                              int Cout) {
  const long long f32 = dw_part_elems(B, H, W, Cin, Cout, 3);
  const long long tc = dw_tc_part_elems(B, H, W, Cin, Cout);
  return f32 > tc ? f32 : tc;
}

// x [B][H][W][Cin], g [B][H][W][Cout] (same dtype), dw [3][3][Cin][Cout]
// float32, part: smsut_conv3x3_dw_scratch floats.
extern "C" int smsut_conv3x3_dw(const void* x, const void* g, void* dw,
                                void* part, int B, int H, int W, int Cin,
                                int Cout, int dtype, void* stream) {
  if (Cout % 16 != 0 || Cin < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_dw<float, 3, false>(
        (const float*)x, (const float*)g, nullptr, (float*)part, (float*)dw,
        B, H, W, Cin, Cout, s);
  if (dtype == 1)
    return (int)conv3x3_dw_tc((const bf16*)x, (const bf16*)g, (float*)part,
                              (float*)dw, B, H, W, Cin, Cout, s);
  return (int)cudaErrorInvalidValue;
}
