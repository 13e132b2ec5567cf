// Pareto dominance on Hopper (sm_90a): the dominance relation of a
// population, as a bool matrix or as bit-packed words, and the whole
// non-dominated front peel over the packed words in one cooperative kernel.
//
// Replaces the TPU kernel `_dominance_kernel` of evox_tpu/ops/dominance.py
// (Pallas, called through `dominance_matrix`), and the XLA packed route
// `_non_dominate_rank_packed` of evox_tpu/operators/selection/non_dominate.py
// (its packed words, its popcount peel and the `_peel_fronts` while loop)
// that the JAX package takes by default above 2048 rows.
//
//   A[i, j] = (for all k: f[i,k] <= f[j,k]) and (for some k: f[i,k] < f[j,k])
//
// Every compare with NaN is false, so a row holding a NaN dominates nothing
// and is dominated by nothing, as in the JAX package's broadcast compare.
//
// Outputs:
//   * bool matrix  out[i * n + j]  (n, n) bytes (`dominance_matrix`);
//   * packed words out[w * n + j]  (ceil(n/32), n) uint32: bit b of word
//     (w, j) is A[32w + b, j] (the layout of non_dominate.py:133-156).
//     Bits of rows >= n are 0.
//
// Packed words (`dominance_packed`).  What bounds it on an H100: issue
// slots.  The relation is n^2 pairs of about 2m compares (n = 20000, m = 3:
// ~2.4e9 lane operations, ~0.07 ms at ~3.3e13 a second); its only bytes are
// n*m inputs and n^2/8 bytes of words (50 MB, ~0.015 ms).  Float compares
// issue at half the rate of the scheduler (two warp instructions a clock on
// an SM), so the design spends as few compares and other integer-pipe
// instructions per pair as it can:
//   * one warp makes kWords consecutive words for 32 columns at a time: lane
//     b holds dominator row 32w+b's m objectives in registers (one row per
//     word), the column's m values are one shared-memory broadcast that
//     serves all kWords words;
//   * each lane evaluates its pair with no branch, as two predicate-combining
//     compare chains written in PTX (m known at compile time for m = 2, 3,
//     4): `le = AND_k x_k <= y_k`, `ge = AND_k x_k >= y_k`.  Where every
//     compare holds there is no NaN, so "x dominates y" is `le && !ge` and
//     "y dominates x" is `ge && !le`: one set of compares gives both
//     directions, and each unordered pair of 32-row blocks is made once (the
//     warp of the lower block writes both words);
//   * `__ballot_sync(le && !ge)` is the finished word of the lane rows at
//     column y, stashed in shared memory (every lane keeps its column's);
//     `ge && !le` sets bit y of the lane's own word of the column block's
//     rows; each 32 columns end in coalesced 128-byte stores of both.
// Rows and columns past n are NaN, so they vote false and are never stored.
// Other m take a generic kernel, the rows in shared memory (one word a warp,
// every column, no symmetry) and the objective loop run at run time, still
// without an early exit.  Tensor cores and TMA do not help: the work is
// compares.
//
// `peel_fronts` is the whole front peel of non_dominate_rank in one
// cooperative launch, with no host sync: the dominate count (phase 0), then
// for each front the popcount of its rows over the words, one grid-wide
// barrier (`grid.sync()`) a front.  What bounds it on an H100: bytes, the
// words read once for the count (50 MB at the NSGA-II path's 20,000 columns,
// much of it in the 50 MB L2 right after dominance_packed wrote it) and then
// the word rows holding each front's rows; and, at many fronts, the chain of
// barriers.  The design:
//   * the G = SMs blocks (one an SM; 256 threads, 1024 from 256 word rows
//     on, where a front's word rows need more loads in flight than a small
//     peel's barriers cost) split the tiles of 32
//     columns evenly (sizes differ by one), planned on the host
//     (ops/dominance.py `_peel_plan`); a lane reads 4 adjacent columns of a
//     word row (16 bytes; 8 or 4 where n is not a multiple of 4), the
//     block's thread rows take every R-th word row, eight loads in flight;
//   * a block keeps its columns' counts in shared memory and ranks them
//     itself; a front is published as dense mask words, one a tile, written
//     by the tile's owner into one of two buffers: nothing is zeroed, no
//     counter is shared, and phase 0 writes front 0's ranks, so a call whose
//     first front reaches `until` (the NSGA-II path) ends after one barrier;
//   * later fronts read only the word rows of their non-zero mask words
//     (compacted in order into a list in shared memory) and skip column
//     vectors already ranked; where the block's columns of every word row
//     fit in shared memory (up to about 13,000 columns on 132 SMs:
//     init_step's 10,000), phase 0 keeps them there and later fronts read
//     no device memory but the mask words;
//   * the thread rows' sums meet in shared memory in a fixed order, no
//     atomics.
// The dominate count stays inside this kernel rather than in
// dominance_packed's epilogue: that would need the counts zeroed first (a
// fill launch) and atomics across the blocks of a column.  Its times are
// PERF.md's kernel table, row 4.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;     // threads of a block (8 warps)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block can use

template <typename T> __device__ __forceinline__ T nan_value();
template <> __device__ __forceinline__ float nan_value<float>() { return __int_as_float(0x7FC00000); }
template <> __device__ __forceinline__ double nan_value<double>() {
  return __longlong_as_double(0x7FF8000000000000LL);
}

// ---------------------------------------------------------------------------
// Packed words, m known at compile time.
// ---------------------------------------------------------------------------

constexpr int kWords = 4;    // words a warp makes (dominator rows 32 * kWords)
constexpr int kCols = 128;   // columns of a block
constexpr int kBlockWords = kWarps * kWords;

// One pair (lane row x, column y) of a warp, both directions from one set of
// compares, written in PTX so that the compares stay predicate-combining
// setp chains and nothing is moved to registers or branched around:
//   le = AND_k x_k <= y_k,  ge = AND_k x_k >= y_k
//   x dominates y  <=>  le && !ge   (every compare true: no NaN, so "some <"
//                                    is "not all >=")
//   y dominates x  <=>  ge && !le
// `word` is the warp's ballot of the first (bit b: lane b's row dominates
// y); the second sets `bit` in `mine`.
template <typename T, int M> struct PairStep;

#define DOM_PAIR_TAIL                                                                              \
  " not.pred q_xy, q_ge;\n and.pred q_xy, q_xy, q_le;\n"                                           \
  " not.pred q_yx, q_le;\n and.pred q_yx, q_yx, q_ge;\n"                                           \
  " vote.sync.ballot.b32 %0, q_xy, 0xffffffff;\n"                                                  \
  " @q_yx or.b32 %1, %1, %2;\n}\n"

#define DOM_PAIR_STEP(T, M, BODY, ...)                                                             \
  template <> struct PairStep<T, M> {                                                              \
    static __device__ __forceinline__ void run(const T (&x)[M], const T (&y)[M], uint32_t bit,     \
                                               uint32_t& word, uint32_t& mine) {                   \
      asm volatile("{\n .reg .pred q_le, q_ge, q_xy, q_yx;\n" BODY DOM_PAIR_TAIL                   \
                   : "=r"(word), "+r"(mine) : "r"(bit), __VA_ARGS__);                              \
    }                                                                                              \
  };

#define DOM_SETP2(TY)                                                                              \
  " setp.le." TY " q_le, %3, %5;\n setp.le.and." TY " q_le, %4, %6, q_le;\n"                       \
  " setp.ge." TY " q_ge, %3, %5;\n setp.ge.and." TY " q_ge, %4, %6, q_ge;\n"
#define DOM_SETP3(TY)                                                                              \
  " setp.le." TY " q_le, %3, %6;\n setp.le.and." TY " q_le, %4, %7, q_le;\n"                       \
  " setp.le.and." TY " q_le, %5, %8, q_le;\n"                                                      \
  " setp.ge." TY " q_ge, %3, %6;\n setp.ge.and." TY " q_ge, %4, %7, q_ge;\n"                       \
  " setp.ge.and." TY " q_ge, %5, %8, q_ge;\n"
#define DOM_SETP4(TY)                                                                              \
  " setp.le." TY " q_le, %3, %7;\n setp.le.and." TY " q_le, %4, %8, q_le;\n"                       \
  " setp.le.and." TY " q_le, %5, %9, q_le;\n setp.le.and." TY " q_le, %6, %10, q_le;\n"            \
  " setp.ge." TY " q_ge, %3, %7;\n setp.ge.and." TY " q_ge, %4, %8, q_ge;\n"                       \
  " setp.ge.and." TY " q_ge, %5, %9, q_ge;\n setp.ge.and." TY " q_ge, %6, %10, q_ge;\n"

DOM_PAIR_STEP(float, 2, DOM_SETP2("f32"), "f"(x[0]), "f"(x[1]), "f"(y[0]), "f"(y[1]))
DOM_PAIR_STEP(float, 3, DOM_SETP3("f32"), "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(y[0]), "f"(y[1]),
              "f"(y[2]))
DOM_PAIR_STEP(float, 4, DOM_SETP4("f32"), "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(x[3]), "f"(y[0]),
              "f"(y[1]), "f"(y[2]), "f"(y[3]))
DOM_PAIR_STEP(double, 2, DOM_SETP2("f64"), "d"(x[0]), "d"(x[1]), "d"(y[0]), "d"(y[1]))
DOM_PAIR_STEP(double, 3, DOM_SETP3("f64"), "d"(x[0]), "d"(x[1]), "d"(x[2]), "d"(y[0]), "d"(y[1]),
              "d"(y[2]))
DOM_PAIR_STEP(double, 4, DOM_SETP4("f64"), "d"(x[0]), "d"(x[1]), "d"(x[2]), "d"(x[3]), "d"(y[0]),
              "d"(y[1]), "d"(y[2]), "d"(y[3]))

// A warp holds the rows of kWords words (lane b: row 32w + b of each) and
// walks the block's columns 32 at a time.  The relation is made once per
// unordered pair of 32-row blocks: for columns of block b >= w it writes
// word w at those columns (the ballots) and word b at the columns of block w
// (`mine`); pairs below the diagonal (b < w) are left to the warp of word b.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
dominance_words_fixed(const T* __restrict__ f, int n, int nw, uint32_t* __restrict__ words) {
  __shared__ T cols[kCols * M];  // (kCols, M), row-major: one column's M values together
  __shared__ uint32_t ballots[kWarps][kWords * 32];  // a warp's ballots of 32 columns, by word
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * kCols;
  const int last_block = (j0 + kCols) / 32 - 1;  // the last 32-column block of the block's columns
  if (last_block < (int)blockIdx.y * kBlockWords) return;  // below every warp's diagonal
  for (int idx = threadIdx.x; idx < kCols * M; idx += kThreads)
    cols[idx] = j0 + idx / M < n ? f[(long long)j0 * M + idx] : nan_value<T>();
  const int w0 = (blockIdx.y * kWarps + warp) * kWords;
  T x[kWords][M];
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    const int row = (w0 + r) * 32 + lane;
#pragma unroll
    for (int k = 0; k < M; ++k) x[r][k] = row < n ? f[(long long)row * M + k] : nan_value<T>();
  }
  __syncthreads();
  if (w0 >= nw || last_block < w0) return;  // whole warp; no barrier follows
  uint32_t* stash = ballots[warp];
  const int cols_here = min(kCols, n - j0);
  for (int c0 = 0; c0 < cols_here; c0 += 32) {
    const int b = (j0 + c0) / 32;  // these 32 columns are also the rows of word b
    if (b < w0) continue;
    // mine[r]: word b at column 32 (w0 + r) + lane; bit c: column c0 + c
    // dominates this lane's row.
    uint32_t mine[kWords];
#pragma unroll
    for (int r = 0; r < kWords; ++r) mine[r] = 0u;
    uint32_t bit = 1u;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      T y[M];
#pragma unroll
      for (int k = 0; k < M; ++k) y[k] = cols[(c0 + c) * M + k];
#pragma unroll
      for (int r = 0; r < kWords; ++r) {
        uint32_t word;
        PairStep<T, M>::run(x[r], y, bit, word, mine[r]);
        stash[r * 32 + c] = word;  // the same value from every lane
      }
      bit <<= 1;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kWords; ++r) {
      const int w = w0 + r;
      const uint32_t keep = stash[r * 32 + lane];  // word w at column j0 + c0 + lane
      if (w >= nw || b < w) continue;  // below the diagonal: the pair of blocks is made as (b, w)
      const int j = j0 + c0 + lane, i = w * 32 + lane;
      if (j < n) words[(long long)w * n + j] = keep;
      if (b > w && i < n) words[(long long)b * n + i] = mine[r];
    }
    __syncwarp();
  }
}

template <typename T, int M>
int launch_words_fixed(const T* f, int n, uint32_t* words, cudaStream_t s) {
  const int nw = (n + 31) / 32;
  dim3 grid((n + kCols - 1) / kCols, (nw + kBlockWords - 1) / kBlockWords);
  dominance_words_fixed<T, M><<<grid, kThreads, 0, s>>>(f, n, nw, words);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Packed words, any m: one word a warp, rows and columns in shared memory.
// ---------------------------------------------------------------------------

constexpr int kGenericCols = 256;  // columns of a block

template <typename T>
__global__ void __launch_bounds__(kThreads)
dominance_words_generic(const T* __restrict__ f, int n, int m, int nw, uint32_t* __restrict__ words) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rows = reinterpret_cast<T*>(smem_raw);  // (m, kThreads): row r's objective k at k * kThreads + r
  T* cols = rows + kThreads * m;              // (kGenericCols, m), row-major
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.y * kThreads;
  const int j0 = blockIdx.x * kGenericCols;
  for (int idx = threadIdx.x; idx < kThreads * m; idx += kThreads) {
    const int r = idx / m, k = idx % m;
    rows[k * kThreads + r] = r0 + r < n ? f[(long long)r0 * m + idx] : nan_value<T>();
  }
  for (int idx = threadIdx.x; idx < kGenericCols * m; idx += kThreads)
    cols[idx] = j0 + idx / m < n ? f[(long long)j0 * m + idx] : nan_value<T>();
  __syncthreads();
  const int w = blockIdx.y * kWarps + warp;
  if (w >= nw) return;  // whole warp; no barrier follows
  const T* mine = rows + warp * 32 + lane;
  const int cols_here = min(kGenericCols, n - j0);
  for (int c0 = 0; c0 < cols_here; c0 += 32) {
    uint32_t keep = 0u;
    for (int c = 0; c < 32; ++c) {
      const T* y = cols + (c0 + c) * m;
      bool le = true, lt = false;
      for (int k = 0; k < m; ++k) {
        const T a = mine[k * kThreads], b = y[k];
        le = le & (a <= b);
        lt = lt | (a < b);
      }
      const uint32_t word = __ballot_sync(kFull, le & lt);
      keep = lane == c ? word : keep;
    }
    const int j = j0 + c0 + lane;
    if (j < n) words[(long long)w * n + j] = keep;
  }
}

template <typename T>
int launch_words(const void* fv, int n, int m, void* out, cudaStream_t s) {
  const T* f = (const T*)fv;
  uint32_t* words = (uint32_t*)out;
  if (n <= 0) return (int)cudaGetLastError();
  switch (m) {
    case 2: return launch_words_fixed<T, 2>(f, n, words, s);
    case 3: return launch_words_fixed<T, 3>(f, n, words, s);
    case 4: return launch_words_fixed<T, 4>(f, n, words, s);
    default: break;
  }
  const size_t smem = sizeof(T) * (size_t)(kThreads + kGenericCols) * (size_t)m;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(dominance_words_generic<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nw = (n + 31) / 32;
  dim3 grid((n + kGenericCols - 1) / kGenericCols, (nw + kWarps - 1) / kWarps);
  dominance_words_generic<T><<<grid, kThreads, smem, s>>>(f, n, m, nw, words);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The (n, n) bool matrix: a block stages 256 rows and 256 columns in shared
// memory and each thread walks the rows for its column.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
dominance_matrix_kernel(const T* __restrict__ f, int n, int m, unsigned char* __restrict__ mat) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rows = reinterpret_cast<T*>(smem_raw);  // (kThreads, m), row-major
  T* cols = rows + kThreads * m;              // (m, kThreads)
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kThreads;
  const int r0 = blockIdx.y * kThreads;
  for (int idx = tid; idx < kThreads * m; idx += kThreads) {
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
  const int rows_here = min(kThreads, n - r0);
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

template <typename T>
int launch_matrix(const void* f, int n, int m, void* out, cudaStream_t s) {
  const size_t smem = sizeof(T) * (size_t)(2 * kThreads) * (size_t)m;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(dominance_matrix_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((n + kThreads - 1) / kThreads, (n + kThreads - 1) / kThreads);
    dominance_matrix_kernel<T><<<grid, kThreads, smem, s>>>((const T*)f, n, m, (unsigned char*)out);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// peel_fronts: the cooperative front peel.
//
// Block b owns the 32-column tiles [b * nw / G, (b + 1) * nw / G) of the G
// blocks (tile t is also mask word t: rows 32t .. 32t + 31).  Its columns'
// counts (rows still unranked that dominate the column; -1 once ranked) live
// in its shared memory, and only it writes their ranks.  A front is
// published as its dense mask words: the owner of tile t writes word t of
// buffer k & 1 for front k, zero or not, so no buffer is ever cleared and
// no counter is shared.  Front k is read in iteration k, after the barrier
// that ends iteration k - 1, and its buffer is next written in iteration
// k + 1, after the barrier that ends iteration k: two buffers and one
// barrier a front.  Mask words other blocks wrote are read through L2
// (`__ldcg`), never a stale L1 line.
// ---------------------------------------------------------------------------

// A block has T threads (the plan's: 256, or 1024 for many word rows) and
// stages a front's mask words T at a time.
constexpr int kPeelLoads = 8;  // loads a thread has in flight in phase 0

// V adjacent words of a word row (16, 8 or 4 bytes).
template <int V> __device__ __forceinline__ void load_words(const uint32_t* p, uint32_t (&x)[V]);
template <> __device__ __forceinline__ void load_words<4>(const uint32_t* p, uint32_t (&x)[4]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  x[0] = u.x;
  x[1] = u.y;
  x[2] = u.z;
  x[3] = u.w;
}
template <> __device__ __forceinline__ void load_words<2>(const uint32_t* p, uint32_t (&x)[2]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  x[0] = u.x;
  x[1] = u.y;
}
template <> __device__ __forceinline__ void load_words<1>(const uint32_t* p, uint32_t (&x)[1]) { x[0] = __ldg(p); }

// V words to and from the block's slice in shared memory (16-byte aligned
// for V = 4).
template <int V> __device__ __forceinline__ void store_slice(uint32_t* p, const uint32_t (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = x[e];
  }
}
template <int V> __device__ __forceinline__ void load_slice(const uint32_t* p, uint32_t (&x)[V]) {
  if constexpr (V == 4) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    x[0] = u.x;
    x[1] = u.y;
    x[2] = u.z;
    x[3] = u.w;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) x[e] = p[e];
  }
}

// The block's sum of v, in every thread (two barriers; `red` free after).
template <int T>
__device__ __forceinline__ int block_sum(int v, int* red) {
  v = __reduce_add_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int total = __reduce_add_sync(kFull, lane < T / 32 ? red[lane] : 0);
  __syncthreads();
  return total;
}

// Columns of a block, at most (shared memory is sized for every block).
__host__ __device__ __forceinline__ int peel_capacity(int nw, int blocks) {
  return 32 * ((nw + blocks - 1) / blocks);
}

// Shared memory of a block without the word slice, and with it: the
// block's columns of every word row (4 * capacity * nw bytes), kept when it
// fits so that later fronts read their words from shared memory.
__host__ __device__ __forceinline__ size_t peel_smem_base(int nw, int blocks, int threads) {
  const int staged = nw < threads ? nw : threads;
  return sizeof(int) * (2 * (size_t)peel_capacity(nw, blocks) + 3 * (size_t)(threads / 32) + 4 * (size_t)threads) +
         sizeof(uint2) * (size_t)staged;
}

__host__ __device__ __forceinline__ size_t peel_slice(int nw, int blocks) {
  return sizeof(uint32_t) * (size_t)peel_capacity(nw, blocks) * (size_t)nw;
}

__host__ __device__ __forceinline__ bool peel_cached(int nw, int blocks, int threads) {
  return peel_smem_base(nw, blocks, threads) + peel_slice(nw, blocks) <= (size_t)kMaxSmem;
}

__host__ __device__ __forceinline__ size_t peel_smem(int nw, int blocks, int threads) {
  return peel_smem_base(nw, blocks, threads) + (peel_cached(nw, blocks, threads) ? peel_slice(nw, blocks) : 0);
}

// The non-zero mask words of cur[0 .. len) (len <= T, a word a thread) as
// (index, word) pairs in `list`, in order; returns their number and sets
// *size to the words' popcount.  The offsets are a block scan (`scan`:
// 2 * T / 32 ints).  Two barriers; `list` is complete after.
template <int T>
__device__ __forceinline__ int stage_front(const uint32_t* cur, int len, uint2* list, int* scan, int* size) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t m = (int)threadIdx.x < len ? __ldcg(cur + threadIdx.x) : 0u;
  const uint32_t ballot = __ballot_sync(kFull, m != 0u);
  const int bits = __reduce_add_sync(kFull, __popc(m));
  if (lane == 0) {
    scan[warp] = __popc(ballot);
    scan[T / 32 + warp] = bits;
  }
  __syncthreads();
  int off = __popc(ballot & ((1u << lane) - 1u)), total = 0, total_bits = 0;
#pragma unroll
  for (int w = 0; w < T / 32; ++w) {
    const int c = scan[w];
    off += w < warp ? c : 0;
    total += c;
    total_bits += scan[T / 32 + w];
  }
  if (m) list[off] = make_uint2(threadIdx.x, m);
  __syncthreads();
  *size = total_bits;
  return total;
}

// Publish the front the block's counts hold (count 0) for its tiles: the
// tiles' mask words into `out`, rank `front` for its columns (and, from
// phase 0, the sentinel n for every other column).
template <int T>
__device__ __forceinline__ void publish(const int* count, int t0, int t1, int n, int front, bool first,
                                        int* rank, uint32_t* out) {
  const int lane = threadIdx.x & 31;
  for (int t = t0 + (threadIdx.x >> 5); t < t1; t += T / 32) {
    const int j = t * 32 + lane;
    const bool in = j < n && count[j - t0 * 32] == 0;
    const uint32_t m = __ballot_sync(kFull, in);
    if (lane == 0) out[t] = m;
    if (in || (first && j < n)) rank[j] = in ? front : n;
  }
}

// The block's column sums into dst[0 .. ncols): with one thread row each
// thread added its own columns' sums into dst already; with more, each
// thread's sums (one vector of V columns) meet in `part` and are added up
// row by row, in a fixed order.  Ends with a barrier.
template <int V, int T>
__device__ __forceinline__ void reduce_rows(const int (&tot)[V], int* dst, int* part, int rows, int r, int q0,
                                            int ncols, bool active) {
  if (rows > 1) {
    if (active) {
#pragma unroll
      for (int e = 0; e < V; ++e) part[r * ncols + q0 * V + e] = tot[e];
    }
    __syncthreads();
    for (int x = threadIdx.x; x < ncols; x += T) {
      int sum = 0;
      for (int i = 0; i < rows; ++i) sum += part[i * ncols + x];
      dst[x] = sum;
    }
  }
  __syncthreads();
}

// Grid: G blocks of T, all resident (a cooperative launch).  A
// block reads its columns V at a time: its nq = columns / V vectors over
// `span` threads, R = T / span thread rows taking word rows
// r, r + R, ...; the rows' sums meet in shared memory (`reduce_rows`).
template <int V, int T>
__global__ void __launch_bounds__(T)
peel_fronts_kernel(const uint32_t* __restrict__ words, int n, int nw, int until, int* __restrict__ rank,
                   uint32_t* masks) {
  extern __shared__ __align__(16) unsigned char peel_shared[];
  const int tid = threadIdx.x;
  const int t0 = (int)((long long)blockIdx.x * nw / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * nw / gridDim.x);
  const int c0 = t0 * 32;
  const int ncols = min(t1 * 32, n) - c0;
  if (until == 0) {  // no front is ranked
    for (int x = tid; x < ncols; x += T) rank[c0 + x] = n;
    return;
  }
  const int cap = peel_capacity(nw, gridDim.x);
  const bool cached = peel_cached(nw, gridDim.x, T);
  // [nw][cap] when cached: the block's columns of every word row.
  uint32_t* slice = reinterpret_cast<uint32_t*>(peel_shared);
  int* count = reinterpret_cast<int*>(peel_shared + (cached ? peel_slice(nw, gridDim.x) : 0));  // [cap]
  int* sub = count + cap;                             // [cap]: the front's popcounts
  int* scan = sub + cap;                              // [2 * T / 32]
  int* red = scan + 2 * (T / 32);                     // [T / 32]
  int* part = red + T / 32;                           // [T * V]: the thread rows' sums
  uint2* list = reinterpret_cast<uint2*>(part + 4 * T);  // [min(nw, T)]: a front's words
  const int nq = ncols / V;
  const int span = min(nq, T);
  // Thread rows: as many as the block holds, but no more than give each
  // kPeelLoads word rows (fewer partial sums to add up at small n).
  const int rows = min(T / span, max(1, (nw + kPeelLoads - 1) / kPeelLoads));
  const int r = tid / span, q0 = tid % span;
  const bool active = r < rows;
  const uint32_t* base = words + c0;

  // Phase 0: the dominate count (every word row), then front 0.
  for (int x = tid; x < ncols; x += T) count[x] = sub[x] = 0;
  __syncthreads();
  int tot[V] = {};
  if (active) {
    for (int q = q0; q < nq; q += span) {
      int acc[V] = {};
      const uint32_t* col = base + q * V;
      for (int w = r; w < nw; w += kPeelLoads * rows) {
        uint32_t x[kPeelLoads][V];
#pragma unroll
        for (int u = 0; u < kPeelLoads; ++u) {
          const int wu = w + u * rows;
          if (wu < nw) {
            load_words<V>(col + (size_t)wu * n, x[u]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) x[u][e] = 0u;
          }
        }
#pragma unroll
        for (int u = 0; u < kPeelLoads; ++u) {
          if (cached && w + u * rows < nw) store_slice<V>(slice + (w + u * rows) * cap + q * V, x[u]);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] += __popc(x[u][e]);
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        tot[e] += acc[e];
        if (rows == 1) count[q * V + e] = acc[e];
      }
    }
  }
  reduce_rows<V, T>(tot, count, part, rows, r, q0, ncols, active);
  publish<T>(count, t0, t1, n, 0, true, rank, masks);

  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const bool staged = nw <= T;  // the whole front's list in shared memory at once
  int assigned = 0;
  for (int k = 0;; ++k) {
    grid.sync();
    const uint32_t* cur = masks + (size_t)(k & 1) * nw;
    uint32_t* next = masks + (size_t)((k + 1) & 1) * nw;
    int size, len = 0;
    if (staged) {
      len = stage_front<T>(cur, nw, list, scan, &size);
    } else {
      int s = 0;
      for (int w = tid; w < nw; w += T) s += __popc(__ldcg(cur + w));
      size = block_sum<T>(s, red);
    }
    if (size == 0) break;  // front k's rows (its ranks are written)
    assigned += size;
    if (until > 0 && assigned >= until) break;  // front k + 1 is never looked at
    // Front k's popcount over the block's columns that are still unranked,
    // from the word rows of its non-zero mask words; a vector whose columns
    // are all ranked (or in front k) is skipped.
#pragma unroll
    for (int e = 0; e < V; ++e) tot[e] = 0;
    for (int w0 = 0; w0 < nw; w0 += T) {
      if (!staged) {
        int ignored;
        len = stage_front<T>(cur + w0, min(T, nw - w0), list, scan, &ignored);
      }
      if (!active) continue;
      for (int q = q0; q < nq; q += span) {
        bool open = false;
#pragma unroll
        for (int e = 0; e < V; ++e) open |= count[q * V + e] > 0;
        if (!open) continue;
        int acc[V] = {};
        const uint32_t* col = base + (size_t)w0 * n + q * V;
#pragma unroll 8
        for (int i = r; i < len; i += rows) {
          const uint2 entry = list[i];
          uint32_t x[V];
          if (cached) {
            load_slice<V>(slice + (w0 + entry.x) * cap + q * V, x);
          } else {
            load_words<V>(col + (size_t)entry.x * n, x);
          }
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] += __popc(x[e] & entry.y);
        }
#pragma unroll
        for (int e = 0; e < V; ++e) {
          tot[e] += acc[e];
          if (rows == 1) sub[q * V + e] += acc[e];
        }
      }
    }
    reduce_rows<V, T>(tot, sub, part, rows, r, q0, ncols, active);
    // Front k drops to -1 (ranked) and never becomes a front again; a
    // column whose count reaches 0 is in front k + 1.
    for (int x = tid; x < ncols; x += T) {
      const int c = count[x];
      count[x] = c > 0 ? c - sub[x] : -1;
      sub[x] = 0;
    }
    __syncthreads();
    publish<T>(count, t0, t1, n, k + 1, false, rank, next);
  }
}

using PeelKernel = void (*)(const uint32_t*, int, int, int, int*, uint32_t*);

template <int T>
PeelKernel peel_kernel_of_threads(int vec) {
  switch (vec) {
    case 4: return peel_fronts_kernel<4, T>;
    case 2: return peel_fronts_kernel<2, T>;
    case 1: return peel_fronts_kernel<1, T>;
    default: return nullptr;
  }
}

PeelKernel peel_kernel_of(int vec, int threads) {
  return threads == 256 ? peel_kernel_of_threads<256>(vec)
         : threads == 1024 ? peel_kernel_of_threads<1024>(vec) : nullptr;
}

// Lets the kernel take `smem` bytes of dynamic shared memory.
cudaError_t peel_allow_smem(PeelKernel kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Plain C entry points for ctypes.  All pointers are device pointers; each
// returns cudaGetLastError() after its launch (0 on success), or the error
// that refused it.
//
// dominance: dtype 0 = float32, 1 = float64; packed != 0 writes the
// (ceil(n/32), n) uint32 words, else the (n, n) bool matrix.
extern "C" int dominance(int dtype, int packed, const void* f, int n, int m, void* out,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return packed ? launch_words<float>(f, n, m, out, s) : launch_matrix<float>(f, n, m, out, s);
  if (dtype == 1)
    return packed ? launch_words<double>(f, n, m, out, s) : launch_matrix<double>(f, n, m, out, s);
  return (int)cudaErrorInvalidValue;
}

// Bytes of scratch peel_fronts needs for n columns of nw words: two
// buffers of nw front mask words.
extern "C" long long peel_fronts_workspace(int n, int nw) {
  (void)n;
  return 8LL * nw;
}

// Blocks of peel_fronts' kernel for `vec` words a load and `threads`
// threads a block (256 or 1024) that one SM holds at once, with the shared
// memory of a grid of `blocks` over nw words; 0 when none fits, -1 for no
// such kernel or an error.
extern "C" int peel_blocks_per_sm(int vec, int nw, int blocks, int threads) {
  const PeelKernel kernel = peel_kernel_of(vec, threads);
  if (kernel == nullptr || nw < 1 || blocks < 1) return -1;
  const size_t smem = peel_smem(nw, blocks, threads);
  if (smem > (size_t)kMaxSmem) return 0;
  if (peel_allow_smem(kernel, smem) != cudaSuccess) return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) != cudaSuccess) return -1;
  return per_sm;
}

// peel_fronts: rank (n,) int32 of every column, from the words; `until` < 0
// peels until a front is empty, else stops before the first front once
// `until` rows are ranked.  `workspace` holds peel_fronts_workspace bytes,
// uninitialised.  The launch plan (ops/dominance.py `_peel_plan`): `vec`
// words a load (n a multiple of it, `words` aligned to its bytes) and
// `blocks` blocks of `threads` (256 or 1024), every one resident.  One cooperative launch made with
// cudaLaunchKernelEx and the cooperative attribute: the form a stream
// capture records as a cooperative kernel node of a CUDA graph.
extern "C" int peel_fronts(const void* words, int n, int nw, int until, void* rank, void* workspace, int vec,
                           int blocks, int threads, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const PeelKernel kernel = peel_kernel_of(vec, threads);
  if (kernel == nullptr || nw != (n + 31) / 32 || n % vec != 0 || (uintptr_t)words % (4 * vec) != 0 ||
      blocks < 1 || blocks > nw)
    return (int)cudaErrorInvalidValue;
  const size_t smem = peel_smem(nw, blocks, threads);
  cudaError_t e = peel_allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, (const uint32_t*)words, n, nw, until, (int*)rank, (uint32_t*)workspace);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
