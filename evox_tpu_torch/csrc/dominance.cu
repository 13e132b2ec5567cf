// Pareto dominance on Hopper (sm_90a): the dominance relation of a
// population, as a bool matrix or as bit-packed words, and the popcount
// reduction that peels non-dominated fronts over the packed words.
//
// Replaces the TPU kernel `_dominance_kernel` of evox_tpu/ops/dominance.py
// (Pallas, called through `dominance_matrix`), and the XLA packed route
// `_non_dominate_rank_packed` of evox_tpu/operators/selection/non_dominate.py
// that the JAX package takes by default above 2048 rows.
//
//   A[i, j] = (for all k: f[i,k] <= f[j,k]) and (for some k: f[i,k] < f[j,k])
//
// Every compare with NaN is false, so a row holding a NaN dominates nothing
// and is dominated by nothing, as in the JAX package's broadcast compare.
//
// Outputs (one kernel template, two layouts):
//   * bool matrix  out[i * n + j]  (n, n) bytes;
//   * packed words out[w * n + j]  (ceil(n/32), n) uint32: bit b of word
//     (w, j) is A[32w + b, j] (the layout of non_dominate.py:133-156).
//     Bits of rows >= n are 0.
//
// `peel_count` computes, for every column j,
//   count[j] = sum_w popcount(word[w, j] & mask[w])
// where mask packs a (n,) bool front (all ones when the front pointer is
// null: the dominate count).  The front is packed into words inside each
// block, from the bool tensor, so the caller launches nothing to pack it.
//
// What bounds it on an H100: operations.  The relation is n^2 pairs times
// about 2m compare/logic lane operations (n = 20000, m = 3: ~2.4e9, ~0.07 ms
// at ~3.3e13 lane operations a second); its only bytes are n*m inputs and
// n^2/8 bytes of packed words (50 MB, ~0.015 ms).  The design: a block
// stages 256 dominator rows and its 256 candidate columns in shared memory
// (rows read as broadcasts, columns one per thread without bank conflicts),
// and each thread walks 8 words x 32 bits for its column, leaving the
// per-objective loop at the first objective that fails `<=`.  The words are
// written once, coalesced across the columns.  The TPU grid's sequential
// j-axis is not carried over: blocks are independent (x: 256 columns,
// y: 256 dominator rows).  peel_count is bound by bytes (it reads the words
// once per front); its grid splits the word range over blocks so that
// n = 20000 gives ~530 blocks, and the partial sums meet with integer
// atomicAdd (exact, order-free).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // candidate columns per block
constexpr int kRows = 256;        // dominator rows per block (8 words)
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block can use

template <typename T, bool kPacked>
__global__ void __launch_bounds__(kThreads)
dominance_kernel(const T* __restrict__ f, int n, int m, void* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rows = reinterpret_cast<T*>(smem_raw);  // (kRows, m), row-major
  T* cols = rows + kRows * m;                 // (m, kThreads)
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kThreads;
  const int r0 = blockIdx.y * kRows;
  for (int idx = tid; idx < kRows * m; idx += kThreads) {
    const int r = r0 + idx / m;
    rows[idx] = r < n ? f[(long long)r * m + idx % m] : T(0);
  }
  for (int idx = tid; idx < kThreads * m; idx += kThreads) {
    const int k = idx / kThreads, c = idx % kThreads;
    const int j = j0 + c;
    cols[idx] = j < n ? f[(long long)j * m + k] : T(0);
  }
  __syncthreads();
  const int j = j0 + tid;
  if (j >= n) return;
  const int rows_here = min(kRows, n - r0);
  if (kPacked) {
    uint32_t* words = reinterpret_cast<uint32_t*>(out);
    const int w0 = r0 / 32;
    for (int w = 0; w * 32 < rows_here; ++w) {
      uint32_t word = 0u;
      const int bits = min(32, rows_here - w * 32);
      for (int b = 0; b < bits; ++b) {
        const T* a = rows + (w * 32 + b) * m;
        bool le = true, lt = false;
        for (int k = 0; k < m; ++k) {
          const T x = a[k], y = cols[k * kThreads + tid];
          if (!(x <= y)) { le = false; break; }
          lt = lt || (x < y);
        }
        if (le && lt) word |= 1u << b;
      }
      words[(long long)(w0 + w) * n + j] = word;
    }
  } else {
    unsigned char* mat = reinterpret_cast<unsigned char*>(out);
    for (int r = 0; r < rows_here; ++r) {
      const T* a = rows + r * m;
      bool le = true, lt = false;
      for (int k = 0; k < m; ++k) {
        const T x = a[k], y = cols[k * kThreads + tid];
        if (!(x <= y)) { le = false; break; }
        lt = lt || (x < y);
      }
      mat[(long long)(r0 + r) * n + j] = (le && lt) ? 1 : 0;
    }
  }
}

template <typename T, bool kPacked>
int launch_dominance(const void* f, int n, int m, void* out, cudaStream_t s) {
  const size_t smem = sizeof(T) * (size_t)(kRows + kThreads) * (size_t)m;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(dominance_kernel<T, kPacked>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((n + kThreads - 1) / kThreads, (n + kRows - 1) / kRows);
    dominance_kernel<T, kPacked><<<grid, kThreads, smem, s>>>((const T*)f, n, m, out);
  }
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads)
peel_count_kernel(const uint32_t* __restrict__ words, const unsigned char* __restrict__ front,
                  int n, int nw, int w_per_block, int* __restrict__ count) {
  extern __shared__ uint32_t mask[];  // (w_per_block,)
  const int tid = threadIdx.x;
  const int w0 = blockIdx.y * w_per_block;
  const int w1 = min(nw, w0 + w_per_block);
  for (int w = w0 + tid; w < w1; w += kThreads) {
    uint32_t word = 0xFFFFFFFFu;
    if (front != nullptr) {
      word = 0u;
      for (int b = 0; b < 32; ++b) {
        const int r = w * 32 + b;
        if (r < n && front[r]) word |= 1u << b;
      }
    }
    mask[w - w0] = word;
  }
  __syncthreads();
  const int j = blockIdx.x * kThreads + tid;
  if (j >= n || w0 >= w1) return;
  int total = 0;
  for (int w = w0; w < w1; ++w) total += __popc(words[(long long)w * n + j] & mask[w - w0]);
  if (total) atomicAdd(count + j, total);
}

}  // namespace

// Plain C entry points for ctypes.  All pointers are device pointers; each
// returns cudaGetLastError() after its launch (0 on success).
//
// dominance: dtype 0 = float32, 1 = float64; packed != 0 writes the
// (ceil(n/32), n) uint32 words, else the (n, n) bool matrix.
extern "C" int dominance(int dtype, int packed, const void* f, int n, int m, void* out,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return packed ? launch_dominance<float, true>(f, n, m, out, s)
                  : launch_dominance<float, false>(f, n, m, out, s);
  if (dtype == 1)
    return packed ? launch_dominance<double, true>(f, n, m, out, s)
                  : launch_dominance<double, false>(f, n, m, out, s);
  return (int)cudaErrorInvalidValue;
}

// peel_count: `count` (n,) int32 must hold zeros; `front` is a (n,) bool
// tensor or null (all ones).  The word range is split into chunks of
// w_per_block words, one grid row each.
extern "C" int peel_count(const void* words, const void* front, int n, int nw,
                          int w_per_block, void* count, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (w_per_block <= 0 || (size_t)w_per_block * 4 > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (n > 0 && nw > 0) {
    const size_t smem = (size_t)w_per_block * 4;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(peel_count_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((n + kThreads - 1) / kThreads, (nw + w_per_block - 1) / w_per_block);
    peel_count_kernel<<<grid, kThreads, smem, s>>>(
        (const uint32_t*)words, (const unsigned char*)front, n, nw, w_per_block, (int*)count);
  }
  return (int)cudaGetLastError();
}
