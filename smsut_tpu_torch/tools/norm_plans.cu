// Device time of K1's and K4's plans (csrc/instnorm.cuh) at each distinct
// norm shape of the U-Net's training step (width 16, 256^2, batch 8), in
// bfloat16 and float32: the plan K1 picks, its two-pass plan, and its
// resident plan where its slices fit a block, with each block's slice bytes
// and whether its clusters fit the card in one wave
// (cudaOccupancyMaxActiveClusters; where they do not, they run in two); and
// K4's plan (two passes).  Times are device ms per call: a spinning kernel
// holds the stream while the host enqueues 20 calls, then CUDA events time
// them.  Built and run by norm_plans.py.
#include <cstdio>

#include "instnorm_bwd.cuh"

using namespace smsut;
typedef __nv_bfloat16 bf;

namespace {

cudaEvent_t t0, t1;

__global__ void spin(long long cycles) {
  const long long start = clock64();
  while (clock64() - start < cycles) {
  }
}

__global__ void fill(float* p, size_t n) {
  for (size_t i = blockIdx.x * 256 + threadIdx.x; i < n; i += gridDim.x * 256)
    p[i] = (float)((i * 2654435761u) % 1000) / 500.f - 1.f;
}

template <class F> float device_ms(F fn) {
  for (int i = 0; i < 3; ++i) fn();
  cudaDeviceSynchronize();
  spin<<<1, 1>>>(4000000);  // about 2 ms
  cudaEventRecord(t0);
  for (int i = 0; i < 20; ++i) fn();
  cudaEventRecord(t1);
  cudaEventSynchronize(t1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, t0, t1);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) printf("error %s\n", cudaGetErrorString(e));
  return ms / 20;
}

template <typename T>
void shape(int B, int H, int C, void* x, void* g, void* y, float* scale,
           float* bias, float* mean, float* rstd, float* scratch, float* dsb,
           unsigned int* tickets) {
  const int HW = H * H, esz = sizeof(T);
  const char* dt = esz == 2 ? "bf16" : "f32";
  auto k1 = [&](const NormPlan& p) {
    return device_ms([&] {
      in_fwd<T>(p, (T*)x, scale, bias, (T*)y, mean, rstd, scratch, tickets, B,
                HW, C, 1, 0);
    });
  };
  const NormPlan pick = in_fwd_plan<T>(B, HW, C);
  const NormPlan two = norm_two_pass_plan(B, HW, C, esz, 1, 2);
  const NormPlan res = norm_resident_plan(B, HW, C, esz, smem_optin_bytes());
  printf("K1 %s [%d,%d,%d,%d]: picked %s (%d blocks) %.4f ms; two-pass (%d "
         "splits) %.4f ms",
         dt, B, H, H, C, pick.resident ? "resident" : "two-pass", pick.nsplit,
         k1(pick), two.nsplit, k1(two));
  if (res.resident && (size_t)res.smem <= smem_optin_bytes()) {
    const void* k = res.vec ? (const void*)in_resident_kernel<T, true>
                            : (const void*)in_resident_kernel<T, false>;
    const int fit = norm_clusters_fit(k, res, (long long)B * res.ng);
    printf("; resident (clusters of %d, %d B of slice and %d B of shared "
           "memory a block, fit at once %d) %.4f ms",
           res.nsplit, res.rows * res.G * esz, res.smem, fit, k1(res));
  }
  printf("\n");
  const NormBwdSrc<T> src{(T*)x, (T*)g, mean, rstd, scale, bias, HW, C, 1};
  const NormPlan pb = in_bwd_plan<T>(B, HW, C);
  printf("K4 %s [%d,%d,%d,%d]: two-pass (%d splits) %.4f ms\n", dt, B, H, H,
         C, pb.nsplit, device_ms([&] {
           in_bwd<T>(pb, src, (T*)y, dsb, scratch, tickets, B, 0);
         }));
}

}  // namespace

int main() {
  cudaEventCreate(&t0);
  cudaEventCreate(&t1);
  const size_t n = (size_t)8 * 65536 * 16;
  void *x, *g, *y;
  float *scale, *bias, *mean, *rstd, *scratch, *dsb;
  unsigned int* tickets;
  cudaMalloc(&x, n * 4);
  cudaMalloc(&g, n * 4);
  cudaMalloc(&y, n * 4);
  cudaMalloc(&scale, 1024 * 4);
  cudaMalloc(&bias, 1024 * 4);
  cudaMalloc(&mean, 8 * 1024 * 4);
  cudaMalloc(&rstd, 8 * 1024 * 4);
  cudaMalloc(&scratch, 64 << 20);
  cudaMalloc(&dsb, 4096 * 4);
  cudaMalloc(&tickets, kNormTicketWords * 4);
  cudaMemset(tickets, 0, kNormTicketWords * 4);
  fill<<<1024, 256>>>((float*)x, n);
  fill<<<1024, 256>>>((float*)g, n);
  fill<<<4, 256>>>(scale, 1024);
  fill<<<4, 256>>>(bias, 1024);
  const int shapes[6][2] = {{256, 16}, {256, 8}, {128, 32},
                            {64, 64}, {32, 128}, {16, 256}};
  for (const auto& s : shapes) {
    shape<bf>(8, s[0], s[1], x, g, y, scale, bias, mean, rstd, scratch, dsb,
              tickets);
    shape<float>(8, s[0], s[1], x, g, y, scale, bias, mean, rstd, scratch,
                 dsb, tickets);
  }
  const cudaError_t e = cudaDeviceSynchronize();
  printf("%s\n", e == cudaSuccess ? "OK" : cudaGetErrorString(e));
  return e == cudaSuccess ? 0 : 1;
}
