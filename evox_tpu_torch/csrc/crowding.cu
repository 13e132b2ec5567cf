// Per-objective lexicographic neighbours for the crowding distance, on
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_neighbor_kernel` of evox_tpu/ops/crowding.py
// (Pallas, called through `crowding_neighbors` and
// `crowding_distance_pallas`).  For every row i and objective k it finds,
// among the VALID rows j (mask[j] != 0), the predecessor and the successor
// of (f[i,k], i) under the order of a stable ascending sort: NaN after
// +inf, all NaNs equal, -0.0 equal to +0.0, ties broken by index.  These
// are exactly the rows beside i in the per-objective stable sort of the
// sort-and-scatter formula, so the gaps built from them are the same floats.
//
// Each (value, index) pair is mapped to one 64-bit integer that orders the
// same way:  key(value) << 32 | index, with key() the usual order-preserving
// map of float bits (sign flip for negatives) after folding -0.0 onto +0.0,
// and every NaN mapped to 0xFFFFFFFF.  No value maps to key 0 (that would be
// a NaN bit pattern), so 0 means "no predecessor"; all-ones means "no
// successor" (indices stay below 2^31).  The predecessor is the largest
// combined key below row i's, the successor the smallest above it.
//
// The TPU kernel carried max/min accumulators across its sequential j-axis
// and needed the flag encodings has_below in {2, 1, 0} and has_above in
// {1, 0.5, 0} to recover a NaN neighbour.  Here the neighbour's INDEX is
// kept, so its value (NaN or a real +-inf included) is read back as it is
// and the existence flags are plain 0/1.  Rows masked out are still given
// their neighbours among the valid rows (the contract of
// crowding_neighbors); rows >= n do not exist for the kernel.
//
// What bounds it on an H100: operations.  n^2 * m candidate steps at ~10
// lane operations each (n = 20000, m = 3: ~1.2e10, ~0.4 ms at ~3.3e13 a
// second) against 13 n m bytes.  The design: a block holds 256 rows of one
// objective; each thread keeps its row's combined key in registers and walks
// tiles of 256 candidate keys staged in shared memory (broadcast reads).
// The candidate range is split over a second grid axis so that n = 20000
// gives ~530 blocks, and partial results meet through 64-bit atomicMax /
// atomicMin on the combined keys (exact and order-free).  A second small
// kernel turns the neighbour indices into the four (n, m) outputs.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kNone = 0ull;
constexpr unsigned long long kNoneAbove = 0xFFFFFFFFFFFFFFFFull;

__device__ __forceinline__ uint32_t order_key(float x) {
  if (x != x) return 0xFFFFFFFFu;
  uint32_t u = __float_as_uint(x);
  if ((u << 1) == 0u) u = 0u;  // -0.0 sorts with +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
neighbor_kernel(const float* __restrict__ costs, const unsigned char* __restrict__ mask,
                int n, int m, int j_per_block, unsigned long long* __restrict__ below,
                unsigned long long* __restrict__ above) {
  __shared__ uint32_t keys[kThreads];
  __shared__ unsigned char ok[kThreads];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  const int k = blockIdx.z;
  const int j0 = blockIdx.y * j_per_block;
  const int j1 = min(n, j0 + j_per_block);
  const unsigned long long own =
      i < n ? ((unsigned long long)order_key(costs[(long long)i * m + k]) << 32) | (unsigned)i
            : 0ull;
  unsigned long long lo = kNone, hi = kNoneAbove;
  for (int t = j0; t < j1; t += kThreads) {
    const int j = t + tid;
    if (j < j1) {
      keys[tid] = order_key(costs[(long long)j * m + k]);
      ok[tid] = mask[j];
    }
    __syncthreads();
    const int len = min(kThreads, j1 - t);
    for (int c = 0; c < len; ++c) {
      if (!ok[c]) continue;
      const unsigned long long cand = ((unsigned long long)keys[c] << 32) | (unsigned)(t + c);
      if (cand < own && cand > lo) lo = cand;
      if (cand > own && cand < hi) hi = cand;
    }
    __syncthreads();
  }
  if (i < n) {
    const long long e = (long long)i * m + k;
    if (lo != kNone) atomicMax(below + e, lo);
    if (hi != kNoneAbove) atomicMin(above + e, hi);
  }
}

__global__ void __launch_bounds__(kThreads)
neighbor_values_kernel(const float* __restrict__ costs, const unsigned long long* __restrict__ below,
                       const unsigned long long* __restrict__ above, long long total, int m,
                       float* __restrict__ below_v, float* __restrict__ above_v,
                       float* __restrict__ has_below, float* __restrict__ has_above) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int k = (int)(e % m);
  const unsigned long long lo = below[e], hi = above[e];
  const bool has_lo = lo != kNone, has_hi = hi != kNoneAbove;
  below_v[e] = has_lo ? costs[(long long)(uint32_t)lo * m + k] : -CUDART_INF_F;
  above_v[e] = has_hi ? costs[(long long)(uint32_t)hi * m + k] : CUDART_INF_F;
  has_below[e] = has_lo ? 1.0f : 0.0f;
  has_above[e] = has_hi ? 1.0f : 0.0f;
}

}  // namespace

// Plain C entry point for ctypes.  costs: (n, m) float32; mask: (n,) bool;
// below_idx / above_idx: (n, m) uint64 scratch holding 0 and all-ones;
// outputs (n, m) float32: neighbour values and 0/1 existence flags.  The
// candidate range is split into chunks of j_per_block rows.  Returns
// cudaGetLastError() after the two launches.
extern "C" int crowding_neighbors(const void* costs, const void* mask, int n, int m,
                                  int j_per_block, void* below_idx, void* above_idx,
                                  void* below_v, void* above_v, void* has_below,
                                  void* has_above, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (j_per_block <= 0 || m <= 0 || m > 65535) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    dim3 grid((n + kThreads - 1) / kThreads, (n + j_per_block - 1) / j_per_block, m);
    neighbor_kernel<<<grid, kThreads, 0, s>>>(
        (const float*)costs, (const unsigned char*)mask, n, m, j_per_block,
        (unsigned long long*)below_idx, (unsigned long long*)above_idx);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const long long total = (long long)n * m;
    neighbor_values_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        (const float*)costs, (const unsigned long long*)below_idx,
        (const unsigned long long*)above_idx, total, m, (float*)below_v, (float*)above_v,
        (float*)has_below, (float*)has_above);
  }
  return (int)cudaGetLastError();
}
