// The device code of K3's chain (block.cu) and of its phases split over a
// space group (block_split.cu): the out pass, the partial counts of the
// chain's convs and the convs themselves, each writing its statistics'
// partials.
#pragma once

#include <type_traits>

#include "conv_tile.cuh"
#include "conv3x3_tc.cuh"

namespace smsut {

template <typename T>
__global__ void __launch_bounds__(256)
block_out_kernel(const T* __restrict__ y2, const float* __restrict__ gh2,
                 const T* __restrict__ idn, const float* __restrict__ ghs,
                 T* __restrict__ out, long long n4, int HWC, int C) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * 4;
    const int b = (int)(e / HWC);
    const int c = (int)(e % C);
    const float* g2 = gh2 + (size_t)2 * b * C;
    float v[4], d[4];
    load4(y2 + e, v);
    load4(idn + e, d);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // rounded as the plain version and K6's rebuild of pre round it
      float t = mul_add_rn(v[k], g2[c + k], g2[C + c + k]);
      if (ghs) {
        const float* gs = ghs + (size_t)2 * b * C;
        t = __fadd_rn(t, mul_add_rn(d[k], gs[c + k], gs[C + c + k]));
      } else {
        t = __fadd_rn(t, d[k]);
      }
      v[k] = lrelu(t);
    }
    store4(out + e, v);
  }
}

// The partials per sample of each conv of the chain (conv1, conv2, the
// shortcut), per dtype; false where the bfloat16 plan refuses one.
static bool block_ntiles(int B, int H, int W, int Ci, int Co, int dtype,
                         int nt[3]) {
  if (dtype == 0) {
    nt[0] = nt[1] = nt[2] = conv_ntiles(H, W, Co);
    return true;
  }
  nt[0] = tc_fwd_tiles(B, H, W, Ci, Co, 3);
  nt[1] = tc_fwd_tiles(B, H, W, Co, Co, 3);
  nt[2] = tc_fwd_tiles(B, H, W, Ci, Co, 1);
  return nt[0] > 0 && nt[1] > 0 && nt[2] > 0;
}

// conv1 (k 0), conv2 with norm 1's (g, h) applied while staging (k 1), the
// 1x1 shortcut (k 2), each writing its statistics' partials over y's H
// rows; with WIN, x holds hin rows at the row offset off (the convs' row
// window: a space rank's rows with their halos)
template <int K, bool WIN = false>
static cudaError_t block_conv(const float* x, const float* w, float* y,
                              const float* gh, float* part, int B, int H,
                              int W, int Ci, int Co, cudaStream_t s,
                              int hin = 0, int off = 0) {
  return launch_conv_ex<float, float, K == 2 ? 1 : 3, true, K == 1,
                        kEpiNone, WIN>(x, w, y, gh, part, nullptr, nullptr, B,
                                       H, W, Ci, Co, s, hin, off);
}
template <int K, bool WIN = false>
static cudaError_t block_conv(const bf16* x, const bf16* w, bf16* y,
                              const float* gh, float* part, int B, int H,
                              int W, int Ci, int Co, cudaStream_t s,
                              int hin = 0, int off = 0) {
  return conv3x3_tc<K == 2 ? 1 : 3, bf16, true, K == 1, kEpiNone, WIN>(
      x, w, y, B, H, W, Ci, Co, s, -1,
      TcOpts{part, gh, nullptr, nullptr, hin, off});
}

}  // namespace smsut
