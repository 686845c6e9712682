// Instance-norm device code, NHWC, float32 or bfloat16: the plans, the
// pieces that K1 (instnorm.cu), K4 (instnorm_bwd.cuh) and K6's norm
// backwards (block_bwd.cu) share, and K1's kernels.
//
// Per (sample b, channel c) the sums run over the H*W pixels in float32.
// K4 and K6 take the two-pass plan; K1 takes one of two, by shape
// (in_fwd_plan):
//
// - resident: the TPU kernel holds one sample's [H, W, C] map in VMEM; here
//   a thread-block cluster holds it in the shared memory of its blocks.  One
//   cluster of K <= 16 blocks per (sample, channel group); block `rank`
//   stages its slice of `rows` pixels with 16-byte cp.async copies (four
//   commit groups, summed as they land), sums in float32 registers, reduces
//   over lanes by __shfl_xor_sync and over warps in shared memory, then
//   reads every block's partials over distributed shared memory in rank
//   order (so every block gets the same sums, bit for bit), and writes its
//   output from shared memory.  One launch, one read of the input from
//   device memory and one write.  It runs where the slices fit, hold at
//   least kNormMinResidentBytes a block, and the clusters fit the card in
//   one wave: a 16-block cluster of one block per SM fits only 7 times on
//   the H100 (cudaOccupancyMaxActiveClusters), so a batch of 8 samples of 2
//   MiB (bfloat16 at 256^2 x 16) takes two passes, which the H100 runs
//   faster than two waves of clusters (smsut_tpu_torch/tools/norm_plans.cu).
// - two-pass: norm_sums_kernel sums each block's slice (16-byte loads, four
//   in flight per thread) into a float32 partial per (sample, split,
//   channel); an integer ticket per (sample, group) elects the block that
//   arrives last, which adds the splits in order, and, where the batch sums
//   are asked for, a last ticket elects the last of those, which adds the
//   samples in order.  No float atomics: runs agree bit for bit.  Then one
//   more pass reads the input again (mostly from the 50 MB L2) and writes
//   the output.
//
// Channels are cut into groups only down to 32 bytes per pixel, one sector.
// A pixel's group is read in units of 16 bytes (8 bfloat16 or 4 float32
// channels: the vector path, C * size % 16 == 0) or of one element (the
// scalar path, any C >= 1).
//
// The tickets are kNormTicketWords words that the caller keeps per stream
// (ops/instnorm.py `tickets`), zero between calls: the block that takes a
// ticket last resets it, and the calls on one stream run one after another.
#pragma once

#include <cooperative_groups.h>

#include <map>
#include <set>
#include <tuple>

#include "mma_tile.cuh"

namespace smsut {

namespace cg = cooperative_groups;

constexpr int kNormThreads = 256;
constexpr int kNormWarps = kNormThreads / 32;
constexpr int kNormMaxCluster = 16;       // non-portable on the H100
constexpr int kNormMinGroupBytes = 32;    // one sector per pixel
constexpr long long kNormSliceBytes = 64 * 1024;   // two-pass: per block
constexpr size_t kNormResidentBytes = 160 * 1024;  // resident: slice bytes
constexpr int kNormFill = 128;            // blocks that fill the card
constexpr int kNormMaxPartials = 2048;    // floats a finalizing block adds
constexpr int kNormTickets = 4096;        // per (sample, group), + 1 last
constexpr int kNormTicketWords = kNormTickets + 1;
// resident only where a block holds at least this much: below it the
// cluster's synchronisation costs more than the second read saves (bf16
// 16^2 x 256, 8 KiB a block: 0.0116 ms resident, 0.0097 two-pass; at 16 KiB
// and more resident is as fast or faster; tools/norm_plans.cu on the H100)
constexpr int kNormMinResidentBytes = 16 * 1024;

struct NormPlan {
  int resident;  // 1: one launch from shared memory, a cluster per (b, group)
  int vec;       // 16-byte units; 0: one element per unit
  int ng, G, U;  // channel groups, channels per group, units per pixel
  int nsplit;    // blocks per (sample, group): the cluster size if resident
  int rows;      // pixels per block
  int smem;      // dynamic shared memory per block, bytes
};
constexpr int kNormPlanWords = 8;

// a plan as the words the entry points hand to Python and take back
inline void norm_plan_words(const NormPlan& p, int* w) {
  const int v[kNormPlanWords] = {p.resident, p.vec, p.ng, p.G,
                                 p.U, p.nsplit, p.rows, p.smem};
  for (int i = 0; i < kNormPlanWords; ++i) w[i] = v[i];
}
inline NormPlan norm_plan_of(const int* w) {
  return NormPlan{w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7]};
}

// the reduction scratch: one row of U units of NS x V sums per warp (U a
// power of two up to 16, reduced over lanes first) or per pixel row
__host__ __device__ inline bool norm_shfl(int U) {
  return U <= 16 && (U & (U - 1)) == 0;
}
__host__ __device__ inline int norm_red_floats(int U, int NS, int V) {
  return (norm_shfl(U) ? kNormWarps : kNormThreads / U) * U * NS * V;
}
__host__ __device__ inline int norm_slice_bytes(int rows, int G, int esz) {
  return (rows * G * esz + 15) / 16 * 16;
}
// resident (K1): the slice, the reduction scratch, the partials [2][G]
// that the cluster exchanges and the statistics [2][G]
__host__ __device__ inline int norm_resident_smem(int rows, int G, int U,
                                                  int esz, int V) {
  return norm_slice_bytes(rows, G, esz) +
         (norm_red_floats(U, 2, V) + 4 * G) * 4;
}

// The channel groups a plan may cut C channels of esz bytes into, widest
// first: ng divides C, a group holds whole units of V channels, and none is
// narrower than a sector unless it is all of C.  Returns their number.
inline int norm_groups(int C, int esz, int V, int (&groups)[64]) {
  int n = 0;
  for (int ng = 1; ng <= C && n < 64; ++ng) {
    if (C % ng) continue;
    const int G = C / ng;
    if (ng > 1 && G * esz < kNormMinGroupBytes && n > 0) break;
    if (G % V || G / V > kNormThreads) continue;
    groups[n++] = ng;
  }
  return n;
}

// The two-pass plan of a sums pass that reads `maps` maps of esz-byte
// elements and takes NS sums per channel (K1, K4, K6's norm backwards): the
// widest group that gives enough blocks, splits of about kNormSliceBytes,
// and no more partials per (sample, group) than a finalizing block adds
// quickly.
inline NormPlan norm_two_pass_plan(int B, int HW, int C, int esz, int maps,
                                   int NS) {
  NormPlan p{};
  p.vec = (C * esz) % 16 == 0;
  const int V = p.vec ? 16 / esz : 1;
  int groups[64];
  const int n = norm_groups(C, esz, V, groups);
  for (int i = 0; i < n; ++i) {
    const int ng = groups[i], G = C / ng;
    const long long bytes = (long long)HW * G * esz * maps;
    long long ns = (bytes + kNormSliceBytes - 1) / kNormSliceBytes;
    const long long fill = (2LL * kNormFill + (long long)B * ng - 1) /
                           ((long long)B * ng);
    if (ns < fill) ns = fill;
    if (ns > kNormMaxPartials / (NS * G)) ns = kNormMaxPartials / (NS * G);
    if (ns > HW) ns = HW;
    if (ns < 1) ns = 1;
    p.ng = ng;
    p.G = G;
    p.U = G / V;
    p.rows = (int)((HW + ns - 1) / ns);
    p.nsplit = (HW + p.rows - 1) / p.rows;
    p.smem = norm_red_floats(p.U, NS, V) * 4 + 16;  // + the ticket's flag
    if ((long long)B * ng * p.nsplit >= 2 * kNormFill) break;
  }
  return p;
}

// K1's resident plan: the widest group, the fewest blocks whose slices fit
// the budget (the device's shared memory per block, optin, less 32 KB, at
// most kNormResidentBytes), and at least enough blocks to fill the card.
// resident is 0 where no cluster of kNormMaxCluster blocks holds a sample's
// group.
inline NormPlan norm_resident_plan(int B, int HW, int C, int esz,
                                   size_t optin) {
  NormPlan p{};
  p.vec = (C * esz) % 16 == 0;
  const int V = p.vec ? 16 / esz : 1;
  int groups[64];
  if (norm_groups(C, esz, V, groups) == 0 || optin <= 32 * 1024) return p;
  const size_t budget = optin - 32 * 1024 < kNormResidentBytes
                            ? optin - 32 * 1024
                            : kNormResidentBytes;
  const int G = C / groups[0], U = G / V;
  int K = 1;
  while (K <= kNormMaxCluster &&
         (size_t)norm_slice_bytes((HW + K - 1) / K, G, esz) > budget)
    K *= 2;
  while ((long long)B * groups[0] * K < kNormFill && K < kNormMaxCluster &&
         2 * K <= HW)
    K *= 2;
  if (K > kNormMaxCluster) return p;
  p.resident = 1;
  p.ng = groups[0];
  p.G = G;
  p.U = U;
  p.nsplit = K;
  p.rows = (HW + K - 1) / K;
  p.smem = norm_resident_smem(p.rows, G, U, esz, V);
  return p;
}

// opt_in, and once per (kernel, device) the permission of clusters over 8
// blocks (the H100 takes 16)
inline cudaError_t norm_opt_in(const void* kernel) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  cudaError_t e = opt_in(kernel);
  int dev = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({kernel, dev})) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) done.insert({kernel, dev});
  return e;
}

// Whether `clusters` clusters of the plan's size fit the card at once, for
// `kernel` (the occupancy query, once per kernel, size and device)
inline bool norm_clusters_fit(const void* kernel, const NormPlan& p,
                              long long clusters) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, int> seen;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  const auto key = std::make_tuple(kernel, p.nsplit, p.smem, dev);
  std::lock_guard<std::mutex> lock(mu);
  auto it = seen.find(key);
  if (it == seen.end()) {
    int n = 0;
    if (norm_opt_in(kernel) != cudaSuccess)
      n = 0;
    else if (p.nsplit == 1) {
      int per_sm = 0, sms = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, kernel, kNormThreads, p.smem) == cudaSuccess &&
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 dev) == cudaSuccess)
        n = per_sm * sms;
    } else {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = p.nsplit;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.gridDim = dim3(p.nsplit * 64, 1, 1);
      cfg.blockDim = dim3(kNormThreads, 1, 1);
      cfg.dynamicSmemBytes = p.smem;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
        n = 0;
    }
    cudaGetLastError();  // a refused query leaves no error behind
    it = seen.emplace(key, n).first;
  }
  return clusters <= it->second;
}

// Launches kernel on grid with kNormThreads threads and `smem` bytes of
// dynamic shared memory, in clusters of `cluster` blocks along x where
// cluster > 1.  Only the resident plan needs the opt-ins: the two-pass
// kernels stay within 48 KB.
template <typename... KArgs, typename... Args>
cudaError_t launch_norm(void (*kernel)(KArgs...), dim3 grid, int cluster,
                        int smem, cudaStream_t s, Args... args) {
  cudaError_t e = cudaSuccess;
  if (cluster > 1 || smem > 48 * 1024)
    e = norm_opt_in(reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  if (cluster > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kNormThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// One unit: V consecutive channels of one pixel, 16 bytes (VEC) or one
// element, to and from float32.
template <typename T, bool VEC> struct NormUnit {
  static constexpr int V = VEC ? 16 / (int)sizeof(T) : 1;
  __device__ __forceinline__ static void load(const T* p, float (&v)[V]) {
    if constexpr (VEC) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      T e[V];
      memcpy(e, &q, 16);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = to_f(e[i]);
    } else {
      v[0] = to_f(*p);
    }
  }
  __device__ __forceinline__ static void store(T* p, const float (&v)[V]) {
    if constexpr (VEC) {
      T e[V];
#pragma unroll
      for (int i = 0; i < V; ++i) e[i] = from_f<T>(v[i]);
      uint4 q;
      memcpy(&q, e, 16);
      *reinterpret_cast<uint4*>(p) = q;
    } else {
      *p = from_f<T>(v[0]);
    }
  }
};

// Adds acc (this thread's NS x V sums of unit tx = t % U over its pixel
// rows) over the block, in a fixed order, to out[k * ostride + c] for the
// group's channels c < G.  Ends with the block synchronised.
template <int NS, int V>
__device__ __forceinline__ void norm_block_sums(float (&acc)[NS][V], int U,
                                                float* red, float* out,
                                                int ostride, int G) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int TY = kNormThreads / U;
  if (norm_shfl(U)) {
    for (int m = U; m < 32; m <<= 1)
#pragma unroll
      for (int k = 0; k < NS; ++k)
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[k][e] += __shfl_xor_sync(0xffffffffu, acc[k][e], m);
    if (lane < U)
#pragma unroll
      for (int k = 0; k < NS; ++k)
#pragma unroll
        for (int e = 0; e < V; ++e)
          red[((warp * U + lane) * NS + k) * V + e] = acc[k][e];
  } else if (t < TY * U) {
#pragma unroll
    for (int k = 0; k < NS; ++k)
#pragma unroll
      for (int e = 0; e < V; ++e) red[(t * NS + k) * V + e] = acc[k][e];
  }
  __syncthreads();
  const int rows = norm_shfl(U) ? kNormWarps : TY;
  for (int i = t; i < NS * G; i += kNormThreads) {
    const int k = i / G, c = i % G, tx = c / V, e = c % V;
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += red[((r * U + tx) * NS + k) * V + e];
    out[(size_t)k * ostride + c] = s;
  }
  __syncthreads();
}

// mean and rstd from the sums of x and x^2 over n pixels, as the reference
// takes them: var = E[x^2] - mean^2, rstd = 1/sqrt(var + eps)
__device__ __forceinline__ void norm_stats(float s1, float s2, float n,
                                           float& mean, float& rstd) {
  mean = s1 / n;
  const float var = s2 / n - mean * mean;
  rstd = 1.f / sqrtf(var + kEps);
}

// A source of summands (XSrc, NormBwdSrc, block_bwd.cu's BlockOutSrc):
// T, NS sums per channel, and for the V channels from c of sample b the
// constants Chan<V> (loaded once per thread, which keeps one unit of
// channels over its pixels) and unit<VEC>(chan, b, px, c, v), the NS
// summands of pixel px.

// x and x^2 of one unit: K1's summands
template <typename T_> struct XSrc {
  typedef T_ T;
  static constexpr int NS = 2;
  const T* x;
  int HW, C;
  template <int V> struct Chan {
    __device__ __forceinline__ Chan(const XSrc&, int, int) {}
  };
  template <bool VEC>
  __device__ __forceinline__ void unit(
      const Chan<NormUnit<T, VEC>::V>&, int b, int px, int c,
      float (&v)[NS][NormUnit<T, VEC>::V]) const {
    constexpr int V = NormUnit<T, VEC>::V;
    float a[V];
    NormUnit<T, VEC>::load(x + ((size_t)b * HW + px) * C + c, a);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      v[0][e] = a[e];
      v[1][e] = a[e] * a[e];
    }
  }
};

// The sums of channel c over the K blocks of the cluster, in rank order:
// s[k] = sum over ranks of part[k * G + c] of that rank's shared memory.
// Every rank's value is read before any is added, so the reads over
// distributed shared memory overlap.
template <class Cluster>
__device__ __forceinline__ void norm_cluster_sums(Cluster& cluster, int K,
                                                  float* part, int G, int c,
                                                  float (&s)[2]) {
  float q[2][kNormMaxCluster];
#pragma unroll
  for (int r = 0; r < kNormMaxCluster; ++r)
    if (r < K) {
      const float* src = K > 1 ? cluster.map_shared_rank(part, r) : part;
      q[0][r] = src[c];
      q[1][r] = src[G + c];
    }
  s[0] = s[1] = 0.f;
#pragma unroll
  for (int r = 0; r < kNormMaxCluster; ++r)
    if (r < K) {
      s[0] += q[0][r];
      s[1] += q[1][r];
    }
}

// Elects the block that arrives last at ticket j of `target` arrivals:
// true in every thread of that block, which then sees the writes the others
// made before they arrived; it resets the ticket.
__device__ __forceinline__ bool norm_last_arrival(unsigned int* ticket,
                                                  unsigned int target,
                                                  int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int got = atomicAdd(ticket, 1u);
    *flag = got + 1 == target;
    if (*flag) *ticket = 0;
  }
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// Two-pass, pass 1: grid (nsplit * ng, B).  Block (s, gi, b) sums Src's NS
// summands over pixels [s*rows, (s+1)*rows) of sample b, channels of group
// gi, into part [B][nsplit][NS][C].  The last block of each (sample,
// group) adds the splits in order into sums [B][NS][C]; with `out`, the
// last of those adds the samples in order into out [NS][C].  tickets:
// kNormTicketWords words, zero, which the last blocks leave zero.
template <class Src, bool VEC>
__global__ void __launch_bounds__(kNormThreads)
norm_sums_kernel(Src src, int HW, int C, NormPlan p, float* __restrict__ part,
                 float* __restrict__ sums, float* __restrict__ out,
                 unsigned int* __restrict__ tickets) {
  using Un = NormUnit<typename Src::T, VEC>;
  constexpr int V = Un::V, NS = Src::NS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  const int t = threadIdx.x, U = p.U, TY = kNormThreads / U;
  int* flag = reinterpret_cast<int*>(red + norm_red_floats(U, NS, V));
  const int s = blockIdx.x % p.nsplit, gi = blockIdx.x / p.nsplit;
  const int b = blockIdx.y, B = gridDim.y, g0 = gi * p.G;
  const int p0 = s * p.rows, p1 = min(HW, p0 + p.rows);
  float acc[NS][V];
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[k][e] = 0.f;
  if (t < TY * U) {
    const int c = g0 + (t % U) * V;
    const typename Src::template Chan<V> ch(src, b, c);
#pragma unroll 4
    for (int px = p0 + t / U; px < p1; px += TY) {
      float v[NS][V];
      src.template unit<VEC>(ch, b, px, c, v);
#pragma unroll
      for (int k = 0; k < NS; ++k)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[k][e] += v[k][e];
    }
  }
  norm_block_sums<NS, V>(acc, U, red,
                         part + ((size_t)(b * p.nsplit + s) * NS) * C + g0, C,
                         p.G);
  // the last block of this (sample, group)'s ticket adds its splits, for
  // every (sample, group) that shares the ticket
  const int pairs = B * p.ng, q = b * p.ng + gi, j = q % kNormTickets;
  const unsigned int target =
      p.nsplit * ((pairs - 1 - j) / kNormTickets + 1);
  if (!norm_last_arrival(&tickets[j], target, flag)) return;
  for (int r = j; r < pairs; r += kNormTickets) {
    const int rb = r / p.ng, rg0 = (r % p.ng) * p.G;
    for (int i = t; i < NS * p.G; i += kNormThreads) {
      const int k = i / p.G, c = rg0 + i % p.G;
      float v = 0.f;
      for (int sp = 0; sp < p.nsplit; ++sp)
        v += __ldcg(&part[((size_t)(rb * p.nsplit + sp) * NS + k) * C + c]);
      sums[((size_t)rb * NS + k) * C + c] = v;
    }
  }
  if (!out) return;
  const unsigned int finals = pairs < kNormTickets ? pairs : kNormTickets;
  if (!norm_last_arrival(&tickets[kNormTickets], finals, flag))
    return;
  for (int i = t; i < NS * C; i += kNormThreads) {
    float v = 0.f;
    for (int sb = 0; sb < B; ++sb) v += __ldcg(&sums[(size_t)sb * NS * C + i]);
    out[i] = v;
  }
}

// float32 elements of the two-pass scratch: sums, then part
inline long long norm_scratch_elems(const NormPlan& p, int B, int C, int NS) {
  return (long long)B * (p.nsplit + 1) * NS * C;
}

// The sums pass of a two-pass plan over Src; scratch holds sums [B][NS][C]
// then part; tickets as in norm_sums_kernel.
template <class Src>
cudaError_t launch_norm_sums(const Src& src, const NormPlan& p, int B,
                             float* scratch, float* out,
                             unsigned int* tickets, cudaStream_t s) {
  constexpr int NS = Src::NS;
  float* sums = scratch;
  float* part = scratch + (size_t)B * NS * src.C;
  const dim3 grid(p.nsplit * p.ng, B);
  if (p.vec)
    return launch_norm(norm_sums_kernel<Src, true>, grid, 1, p.smem, s, src,
                       src.HW, src.C, p, part, sums, out, tickets);
  return launch_norm(norm_sums_kernel<Src, false>, grid, 1, p.smem, s, src,
                     src.HW, src.C, p, part, sums, out, tickets);
}

// ---- K1 ----

// y = ((x - mean) * rstd) * scale + bias, then the leaky ReLU with act, for
// the V channels of one unit: mean, rstd, scale and bias held in registers
template <int V> struct NormAffine {
  float m[V], r[V], s[V], h[V];
  __device__ __forceinline__ NormAffine(const float* mean, const float* rstd,
                                        const float* scale,
                                        const float* bias) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      m[e] = mean[e];
      r[e] = rstd[e];
      s[e] = scale[e];
      h[e] = bias[e];
    }
  }
  __device__ __forceinline__ void operator()(float (&v)[V], int act) const {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float z = (v[e] - m[e]) * r[e];
      z = z * s[e] + h[e];
      v[e] = act ? lrelu(z) : z;
    }
  }
};

// Resident: grid (K * ng, B), clusters of K blocks along x.  Block rank of
// cluster (gi, b) normalises pixels [rank*rows, (rank+1)*rows) of sample b,
// channels of group gi.  Thread t keeps unit t % U of its pixels' channels
// throughout.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kNormThreads)
in_resident_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ y,
                   float* __restrict__ mean, float* __restrict__ rstd, int HW,
                   int C, NormPlan p, int act) {
  using Un = NormUnit<T, VEC>;
  constexpr int V = Un::V;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, K = p.nsplit, G = p.G, U = p.U;
  const int TY = kNormThreads / U, tx = t % U, cg = tx * V;
  const int rank = blockIdx.x % K, g0 = blockIdx.x / K * G, b = blockIdx.y;
  const int p0 = rank * p.rows, n = max(0, min(HW - p0, p.rows));
  T* xs = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem +
                                        norm_slice_bytes(p.rows, G, sizeof(T)));
  float* part = red + norm_red_floats(U, 2, V);
  float* st = part + 2 * G;
  const T* xb = x + ((size_t)b * HW + p0) * C + g0;
  // 1. the slice, in four groups of copies, summed as each group lands
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q0 = j * n / 4, q1 = (j + 1) * n / 4;
    for (int i = q0 * U + t; i < q1 * U; i += kNormThreads) {
      const T* src = xb + (size_t)(i / U) * C + (i % U) * V;
      if constexpr (VEC)
        cp_async16(smem_addr(xs + (size_t)i * V), src, true);
      else
        xs[i] = *src;
    }
    cp_async_commit();
  }
  float acc[2][V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[0][e] = acc[1][e] = 0.f;
  const bool active = t < TY * U;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j == 0) cp_async_wait<3>();
    if (j == 1) cp_async_wait<2>();
    if (j == 2) cp_async_wait<1>();
    if (j == 3) cp_async_wait<0>();
    __syncthreads();
    const int q0 = j * n / 4, q1 = (j + 1) * n / 4;
    if (active)
      for (int q = q0 + t / U; q < q1; q += TY) {
        float v[V];
        Un::load(xs + ((size_t)q * U + tx) * V, v);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          acc[0][e] += v[e];
          acc[1][e] += v[e] * v[e];
        }
      }
  }
  norm_block_sums<2, V>(acc, U, red, part, G, G);
  // 2. the cluster's partials, in rank order
  cg::cluster_group cluster = cg::this_cluster();
  if (K > 1) cluster.sync();
  for (int c = t; c < G; c += kNormThreads) {
    float s[2];
    norm_cluster_sums(cluster, K, part, G, c, s);
    norm_stats(s[0], s[1], (float)HW, st[c], st[G + c]);
    if (rank == 0) {
      mean[(size_t)b * C + g0 + c] = st[c];
      rstd[(size_t)b * C + g0 + c] = st[G + c];
    }
  }
  // no block leaves while another still reads its partials
  if (K > 1) cluster.sync();
  __syncthreads();
  if (!active) return;
  // 3. the output, from shared memory
  const NormAffine<V> f(st + cg, st + G + cg, scale + g0 + cg,
                        bias + g0 + cg);
  T* yb = y + ((size_t)b * HW + p0) * C + g0 + cg;
#pragma unroll 4
  for (int q = t / U; q < n; q += TY) {
    float v[V];
    Un::load(xs + ((size_t)q * U + tx) * V, v);
    f(v, act);
    Un::store(yb + (size_t)q * C, v);
  }
}

// Two-pass, pass 2: grid (nsplit * ng, B); the statistics of the group from
// the sums pass, then the block's slice.  Split 0 writes mean and rstd.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kNormThreads)
in_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, T* __restrict__ y,
                float* __restrict__ mean, float* __restrict__ rstd,
                const float* __restrict__ sums, int HW, int C, NormPlan p,
                int act) {
  using Un = NormUnit<T, VEC>;
  constexpr int V = Un::V;
  extern __shared__ __align__(16) unsigned char smem[];
  float* st = reinterpret_cast<float*>(smem);
  const int t = threadIdx.x, G = p.G, U = p.U, TY = kNormThreads / U;
  const int s = blockIdx.x % p.nsplit, g0 = blockIdx.x / p.nsplit * G;
  const int b = blockIdx.y;
  const int p0 = s * p.rows, n = max(0, min(HW - p0, p.rows));
  for (int c = t; c < G; c += kNormThreads) {
    const float* S = sums + (size_t)b * 2 * C + g0 + c;
    norm_stats(S[0], S[C], (float)HW, st[c], st[G + c]);
    if (s == 0) {
      mean[(size_t)b * C + g0 + c] = st[c];
      rstd[(size_t)b * C + g0 + c] = st[G + c];
    }
  }
  __syncthreads();
  if (t >= TY * U) return;
  const int cg = (t % U) * V;
  const NormAffine<V> f(st + cg, st + G + cg, scale + g0 + cg,
                        bias + g0 + cg);
  const size_t base = ((size_t)b * HW + p0) * C + g0 + cg;
#pragma unroll 4
  for (int q = t / U; q < n; q += TY) {
    const size_t o = base + (size_t)q * C;
    float v[V];
    Un::load(x + o, v);
    f(v, act);
    Un::store(y + o, v);
  }
}

// K1's plan for a shape: resident where norm_resident_plan gives one whose
// blocks fit the device's shared memory, hold at least
// kNormMinResidentBytes and whose clusters fit the card at once; two-pass
// elsewhere.
template <typename T>
inline NormPlan in_fwd_plan(int B, int HW, int C) {
  const int esz = sizeof(T);
  const size_t optin = smem_optin_bytes();
  const NormPlan r = norm_resident_plan(B, HW, C, esz, optin);
  if (r.resident && (size_t)r.smem <= optin &&
      (long long)r.rows * r.G * esz >= kNormMinResidentBytes) {
    const void* k = r.vec ? reinterpret_cast<const void*>(
                                in_resident_kernel<T, true>)
                          : reinterpret_cast<const void*>(
                                in_resident_kernel<T, false>);
    if (norm_clusters_fit(k, r, (long long)B * r.ng)) return r;
  }
  return norm_two_pass_plan(B, HW, C, esz, 1, 2);
}

// K1 under plan p: one launch (resident) or two; scratch: norm_scratch_elems
// floats and tickets (two-pass only).
template <typename T>
cudaError_t in_fwd(const NormPlan& p, const T* x, const float* scale,
                   const float* bias, T* y, float* mean, float* rstd,
                   float* scratch, unsigned int* tickets, int B, int HW,
                   int C, int act, cudaStream_t s) {
  const dim3 grid(p.nsplit * p.ng, B);
  if (p.resident)
    return p.vec ? launch_norm(in_resident_kernel<T, true>, grid, p.nsplit,
                               p.smem, s, x, scale, bias, y, mean, rstd, HW, C,
                               p, act)
                 : launch_norm(in_resident_kernel<T, false>, grid, p.nsplit,
                               p.smem, s, x, scale, bias, y, mean, rstd, HW, C,
                               p, act);
  cudaError_t e =
      launch_norm_sums(XSrc<T>{x, HW, C}, p, B, scratch, nullptr, tickets, s);
  if (e != cudaSuccess) return e;
  const int smem = 2 * p.G * 4;
  return p.vec ? launch_norm(in_apply_kernel<T, true>, grid, 1, smem, s, x,
                             scale, bias, y, mean, rstd, scratch, HW, C, p, act)
               : launch_norm(in_apply_kernel<T, false>, grid, 1, smem, s, x,
                             scale, bias, y, mean, rstd, scratch, HW, C, p,
                             act);
}

}  // namespace smsut
