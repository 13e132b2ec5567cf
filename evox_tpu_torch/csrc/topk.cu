// Exact lexicographic rank by counting, on Hopper (sm_90a).
//
// Replaces the TPU kernel `_rank_kernel` of evox_tpu/ops/topk.py (Pallas,
// called through `lex_rank` and `masked_top_k`).  For every element i:
//
//   rank[i] = #{ j : (v[j], j) < (v[i], i) }
//
// under the strict total order of a stable ascending sort: NaN after +inf,
// all NaNs equal to each other, -0.0 equal to +0.0, ties broken by index.
// The ranks are therefore a permutation of 0..n-1, the stable-sort position
// of each element.  float32 and int32 (NaN never occurs there).
//
// What bounds it on an H100: operations.  n^2 candidate compares at ~8 lane
// operations each (n = 20000: 3.2e9, ~0.1 ms at ~3.3e13 a second) against
// 4n bytes in and 4n bytes out.  The design: thread i keeps its element in
// registers and walks tiles of 256 candidates staged in shared memory (read
// as broadcasts); the TPU grid's sequential j-axis, which carried the count
// from one step to the next, becomes a loop inside the block.  One thread
// per element gives only ~80 blocks at n = 20000 for 132 SMs, so the
// candidate range is split over a second grid axis and the partial counts
// meet with integer atomicAdd (exact and independent of order).  The
// `out[rank] = i` scatter of masked_top_k is left to the wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ bool is_nan(T x) {
  return x != x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lex_rank_kernel(const T* __restrict__ v, int n, int j_per_block, int* __restrict__ rank) {
  __shared__ T tile[kThreads];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  const int j0 = blockIdx.y * j_per_block;
  const int j1 = min(n, j0 + j_per_block);
  const T a = i < n ? v[i] : T(0);
  const bool a_nan = is_nan(a);
  int count = 0;
  for (int t = j0; t < j1; t += kThreads) {
    if (t + tid < j1) tile[tid] = v[t + tid];
    __syncthreads();
    const int len = min(kThreads, j1 - t);
    for (int c = 0; c < len; ++c) {
      const T b = tile[c];
      const bool b_nan = is_nan(b);
      const bool eq = (b == a) || (b_nan && a_nan);
      const bool less = (b < a) || (!b_nan && a_nan) || (eq && (t + c) < i);
      count += less ? 1 : 0;
    }
    __syncthreads();
  }
  if (i < n && count) atomicAdd(rank + i, count);
}

template <typename T>
int launch(const void* v, int n, int j_per_block, void* rank, cudaStream_t s) {
  if (j_per_block <= 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    dim3 grid((n + kThreads - 1) / kThreads, (n + j_per_block - 1) / j_per_block);
    lex_rank_kernel<T><<<grid, kThreads, 0, s>>>((const T*)v, n, j_per_block, (int*)rank);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = int32.  `rank`
// (n,) int32 must hold zeros.  The candidate range is split into chunks of
// j_per_block elements, one grid row each.  Returns cudaGetLastError().
extern "C" int lex_rank(int dtype, const void* v, int n, int j_per_block, void* rank,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(v, n, j_per_block, rank, s);
  if (dtype == 1) return launch<int>(v, n, j_per_block, rank, s);
  return (int)cudaErrorInvalidValue;
}
