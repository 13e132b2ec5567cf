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
// for each front the popcount of the previous front's rows over the words,
// a grid-wide barrier (`grid.sync()`) between fronts.  A block owns whole
// 32-column tiles (tile t is also mask word t), so it writes its own ranks
// and counts without atomics; a front is kept as a list of its non-zero mask
// words (tile, word) that the owners append to, so a block reads only the
// word rows of the front's members, split over its eight warps.  Bound by
// bytes: (fronts + 1) reads of the words at most, most of them from the
// 50 MB L2 right after dominance_packed wrote them.  The dominate count
// stays inside this kernel rather than in dominance_packed's epilogue: an
// epilogue would need the counts zeroed first (a fill launch) and atomics
// across the blocks of a column, and dominance_packed keeps one job.

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
// Scratch (int32): ctr[8] = front sizes [0..2] and list lengths [3..5] of
// three rotating fronts, count[n] (rows dominating each row; -1 once
// ranked), then three lists of up to nw (tile, mask word) pairs.  Front k
// lives in slot k % 3: iteration k reads slot k % 3, appends front k + 1 to
// slot (k + 1) % 3 and clears slot (k + 2) % 3, whose last reader finished
// before the previous barrier.  Everything a block reads that another block
// wrote goes through L2 (`__ldcg`, atomics), never a stale L1 line.
// ---------------------------------------------------------------------------

constexpr int kListChunk = 1024;  // list entries staged in shared memory at a time

__device__ __forceinline__ int sum_partials(const int (*part)[32], int lane) {
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += part[w][lane];
  return total;
}

__global__ void __launch_bounds__(kThreads)
peel_fronts_kernel(const uint32_t* __restrict__ words, int n, int nw, int until, int* __restrict__ rank,
                   int* ctr, int* count, int2* lists) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  __shared__ int2 chunk[kListChunk];
  __shared__ int part[kWarps][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (blockIdx.x == 0 && tid < 6) ctr[tid] = 0;
  grid.sync();

  // Phase 0: the dominate count and front 0.
  int bsize = 0;  // rows of the next front in this block's tiles (thread 0)
  for (int t = blockIdx.x; t < nw; t += gridDim.x) {
    const int j = t * 32 + lane;
    int s = 0;
    if (j < n) {
#pragma unroll 4
      for (int w = warp; w < nw; w += kWarps) s += __popc(__ldg(words + (size_t)w * n + j));
    }
    part[warp][lane] = s;
    __syncthreads();
    if (warp == 0) {
      const int c = sum_partials(part, lane);
      if (j < n) {
        count[j] = c;
        rank[j] = n;
      }
      const uint32_t word = __ballot_sync(kFull, j < n && c == 0);
      if (lane == 0 && word) {
        lists[atomicAdd(ctr + 3, 1)] = make_int2(t, (int)word);
        bsize += __popc(word);
      }
    }
    __syncthreads();
  }
  if (tid == 0 && bsize) atomicAdd(ctr, bsize);
  grid.sync();

  int assigned = 0;
  for (int k = 0;; ++k) {
    const int cur = k % 3, nxt = (k + 1) % 3;
    const int size = __ldcg(ctr + cur);
    if (size == 0 || (until >= 0 && assigned >= until)) break;
    assigned += size;
    // Front k is the last one ranked: front k + 1 is never looked at.
    const bool last = until >= 0 && assigned >= until;
    const int len = __ldcg(ctr + 3 + cur);
    const int2* list = lists + (size_t)cur * nw;
    int2* next = lists + (size_t)nxt * nw;
    bsize = 0;
    for (int t = blockIdx.x; t < nw; t += gridDim.x) {
      const int j = t * 32 + lane;
      const int c = j < n ? count[j] : -1;
      const bool in_front = c == 0;  // a row of front k
      if (last) {
        if (warp == 0 && in_front) rank[j] = k;
        continue;
      }
      // Rows still unranked (c > 0) take the front's popcount; a ranked row
      // or a row of front k is dominated by no row of front k.
      int sub = 0;
      if (__syncthreads_or(c > 0)) {
        int s = 0;
        for (int c0 = 0; c0 < len; c0 += kListChunk) {
          const int cn = min(kListChunk, len - c0);
          for (int i = tid; i < cn; i += kThreads) chunk[i] = __ldcg(list + c0 + i);
          __syncthreads();
          if (j < n) {
#pragma unroll 4
            for (int i = warp; i < cn; i += kWarps) {
              const int2 e = chunk[i];
              s += __popc(__ldg(words + (size_t)e.x * n + j) & (uint32_t)e.y);
            }
          }
          __syncthreads();
        }
        part[warp][lane] = s;
        __syncthreads();
        if (warp == 0) sub = sum_partials(part, lane);
      }
      if (warp == 0) {
        // The front itself drops to -1 and never becomes a front again.
        const int nc = c - sub - (in_front ? 1 : 0);
        if (j < n) {
          if (in_front) rank[j] = k;
          count[j] = nc;
        }
        const uint32_t word = __ballot_sync(kFull, j < n && nc == 0);
        if (lane == 0 && word) {
          next[atomicAdd(ctr + 3 + nxt, 1)] = make_int2(t, (int)word);
          bsize += __popc(word);
        }
      }
      __syncthreads();  // `part` and `chunk` are free again
    }
    if (last) break;
    if (tid == 0 && bsize) atomicAdd(ctr + nxt, bsize);
    if (blockIdx.x == 0 && tid == 0) {
      const int z = (k + 2) % 3;
      ctr[z] = 0;
      ctr[3 + z] = 0;
    }
    grid.sync();
  }
}

// Blocks of peel_fronts_kernel that fit on the card at once, per device.
int peel_grid_limit() {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int coop = 0, sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return -(int)e;
  if (!coop) return -(int)cudaErrorNotSupported;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return -(int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, peel_fronts_kernel, kThreads, 0);
  if (e != cudaSuccess) return -(int)e;
  if (per_sm < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
  if (dev < 64) cached[dev] = per_sm * sms;
  return per_sm * sms;
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

// Bytes of scratch peel_fronts needs for n columns of nw words.
extern "C" long long peel_fronts_workspace(int n, int nw) {
  return 4LL * (8 + n + (n & 1)) + 8LL * 3 * nw;
}

// peel_fronts: rank (n,) int32 of every column, from the words; `until` < 0
// peels until a front is empty, else stops before the first front once
// `until` rows are ranked.  `workspace` holds peel_fronts_workspace bytes,
// uninitialised.  One cooperative launch, every block resident, made with
// cudaLaunchKernelEx and the cooperative attribute: the form a stream
// capture records as a cooperative kernel node of a CUDA graph.
extern "C" int peel_fronts(const void* words, int n, int nw, int until, void* rank, void* workspace,
                           void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int limit = peel_grid_limit();
  if (limit < 0) return -limit;
  const uint32_t* w = (const uint32_t*)words;
  int* r = (int*)rank;
  int* ctr = (int*)workspace;
  int* count = ctr + 8;
  int2* lists = (int2*)(count + n + (n & 1));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nw < limit ? nw : limit);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, peel_fronts_kernel, w, n, nw, until, r, ctr, count, lists);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
