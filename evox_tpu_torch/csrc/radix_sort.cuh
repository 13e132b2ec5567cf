// Stable LSD radix sort of 32-bit keys with the element index as payload,
// written by hand for Hopper (sm_90a).  The building blocks of
// csrc/topk.cu (lex_rank) and csrc/crowding.cu (crowding_neighbors).
//
// Keys.  Each value maps to a uint32 that orders like the value under a
// stable ascending sort: float32 through `float_key` (NaN on top, -0.0
// folded onto +0.0, the usual sign flip), int32 through `int_key` (sign bit
// flipped).  A STABLE sort of the keys keeps equal keys in index order, so
// ties are broken by index for free: the strict (value, index) order of
// the TPU kernels.
//
// Passes.  Four passes of 8-bit digits, least significant first.  A pass
// whose digit is the same for every key (a histogram with one non-empty
// bin) moves nothing and is skipped; the cluster or the plan kernel decides
// this on the device from the AND and the OR of all keys (byte p of
// AND ^ OR is 0 exactly when every key has the same digit p).  When every
// pass would be skipped, pass 0 runs alone: it keeps the order, and the last
// pass run is the one that writes the result.
//
// Stability across threads.  Items sit in registers, warp-striped: item j
// of lane l of warp w is element (w * I + j) * 32 + l of the block's run
// (I items a thread).  A warp walks its items chunk by chunk (j
// ascending); in each chunk the lanes with equal digits form a group (eight
// ballots, one per digit bit: match_digit), a popcount of the lower lanes
// of the group ranks each lane inside it, and the group's lowest lane bumps
// the warp's own counter for that digit.  Offsets are an exclusive scan
// over (digit, block, warp) in that order, so equal digits land in input
// order: lanes, then chunks, then warps, then blocks.
//
// Two routes, chosen by n:
//   * n <= kCapacity (= 8 blocks x 1024 threads x 8 items = 65,536): one
//     thread-block cluster per segment (Hopper; up to 8 blocks, one SM
//     each) sorts in distributed shared memory.  Each block holds a run of
//     the current order; per pass it ranks its items, pushes its digit
//     totals into every block of the cluster, and, after a cluster
//     barrier, scatters keys and indices straight into the shared memory of
//     the block that holds their new place.  One launch per sort; the
//     NSGA-II path's 20,000 and 10,000 rows and bench.py's 50,000 take this
//     route.  (A single block, one SM, takes ~20 us a pass at 20,000
//     keys; the cluster ~8.)
//   * n > kCapacity: tiles of 256 threads x 20 items over many blocks;
//     per segment a key kernel, a plan kernel (AND/OR over the tiles'
//     partials), then per pass a digit-count kernel, a one-block scan of
//     the (digit, tile) counts and a stable scatter.  Kernels of a skipped
//     pass return at once.  Ping-pong buffers live in a workspace the
//     wrapper allocates; which buffer holds the current order follows from
//     the passes run before (device-side, no host read).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace radix {

namespace cg = cooperative_groups;

constexpr int kDigits = 256;
constexpr int kClusterItems = 8;  // items a thread holds, cluster route
constexpr int kItems = 20;         // items a thread holds, multi-block route
constexpr int kBlockThreads = 1024;
constexpr int kClusterMax = 8;  // the portable thread-block cluster size
constexpr int kCapacity = kClusterMax * kBlockThreads * kClusterItems;  // the crossover: 65,536
// Indices stay below kCapacity <= 2^kIdxBits; above them, between ranking
// and placing, rides an item's rank in its warp (below 32 * kClusterItems).
constexpr int kIdxBits = 16;
constexpr int kTileThreads = 256;
constexpr int kTile = kTileThreads * kItems;  // 5,120 items a tile
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;
constexpr uint32_t kPadKey = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t float_key(float x) {
  if (x != x) return 0xFFFFFFFFu;
  uint32_t u = __float_as_uint(x);
  if ((u << 1) == 0u) u = 0u;  // -0.0 sorts with +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint32_t int_key(int x) { return (uint32_t)x ^ 0x80000000u; }

// Bit p set: pass p (digit bits 8p..8p+7) has to run.
__device__ __forceinline__ unsigned active_passes(uint32_t all_and, uint32_t any_or) {
  const uint32_t diff = all_and ^ any_or;
  unsigned mask = 0;
#pragma unroll
  for (int p = 0; p < 4; ++p)
    if ((diff >> (8 * p)) & 0xFFu) mask |= 1u << p;
  return mask ? mask : 1u;
}

// ---------------------------------------------------------------------------
// Block-wide scans (blockDim.x a multiple of 32, at most 1024).
// ---------------------------------------------------------------------------

// Exclusive prefix sum of one int per thread, in thread order.  scratch:
// 33 ints of shared memory.  Every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < nw ? scratch[lane] : 0;
    int s = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, s, o);
      if (lane >= o) s += y;
    }
    scratch[lane] = s - t;
  }
  __syncthreads();
  const int out = scratch[warp] + x - v;
  __syncthreads();
  return out;
}

// Exclusive scan with combine(a, b) = b >= 0 ? b : a: each thread gets the
// last non-negative value (a row) held by the threads before it, -1 if
// none.  kReverse scans from the last thread down ("the first row after
// me").  scratch: 64 ints of shared memory.  Every thread must call it.
template <bool kReverse>
__device__ __forceinline__ int block_last_row(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int x = v;  // inclusive within the warp, in logical order
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = kReverse ? __shfl_down_sync(0xFFFFFFFFu, x, o) : __shfl_up_sync(0xFFFFFFFFu, x, o);
    const bool in = kReverse ? lane + o < 32 : lane >= o;
    if (in && x < 0) x = y;
  }
  int ex = kReverse ? __shfl_down_sync(0xFFFFFFFFu, x, 1) : __shfl_up_sync(0xFFFFFFFFu, x, 1);
  if (kReverse ? lane == 31 : lane == 0) ex = -1;
  if (kReverse ? lane == 0 : lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    // Logical warp `lane` is physical warp pw.
    const int pw = kReverse ? nw - 1 - lane : lane;
    const int t = lane < nw ? scratch[pw] : -1;
    int s = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, s, o);
      if (lane >= o && s < 0) s = y;
    }
    int before = __shfl_up_sync(0xFFFFFFFFu, s, 1);
    if (lane == 0) before = -1;
    if (lane < nw) scratch[32 + pw] = before;
  }
  __syncthreads();
  const int out = ex >= 0 ? ex : scratch[32 + warp];
  __syncthreads();
  return out;
}

// ---------------------------------------------------------------------------
// A pass over a block's items: ranks and digit counts per warp, offsets.
// ---------------------------------------------------------------------------

// Shared memory of a block of the cluster route: the key and index
// exchange buffers (blockDim * kClusterItems each; the cluster's blocks
// scatter into them), the (warp, digit) counters, every block's digit
// totals (each block pushes its own), per-digit sums over the cluster, scan
// scratch and a few words exchanged across the cluster.
struct Shared {
  uint32_t* keys;
  int* idx;
  int* cnt;
  int* tot;     // (kClusterMax, 256): each block's digit totals, pushed by it
  int* before;  // per digit: items of the blocks of lower rank
  int* all;     // per digit: items of the whole cluster
  int* scratch;  // 64 ints
  uint32_t* and_or;  // 4 words: this block's AND / OR, the cluster's
  int* xch;     // 4 ints, for the callers
};

__host__ __device__ __forceinline__ size_t block_smem_bytes(int threads) {
  return (size_t)threads * kClusterItems * 8 + (size_t)kDigits * (threads / 32) * 4 +
         (kClusterMax + 2) * kDigits * 4 + 64 * 4 + 4 * 4 + 4 * 4;
}

__device__ __forceinline__ Shared block_shared(unsigned char* smem) {
  const int threads = blockDim.x;
  Shared sh;
  sh.keys = (uint32_t*)smem;
  sh.idx = (int*)(sh.keys + (size_t)threads * kClusterItems);
  sh.cnt = sh.idx + (size_t)threads * kClusterItems;
  sh.tot = sh.cnt + kDigits * (threads / 32);
  sh.before = sh.tot + kClusterMax * kDigits;
  sh.all = sh.before + kDigits;
  sh.scratch = sh.all + kDigits;
  sh.and_or = (uint32_t*)(sh.scratch + 64);
  sh.xch = (int*)(sh.and_or + 4);
  return sh;
}

// Place of item j of this thread in the block's warp-striped run of I
// items a thread.
template <int I>
__device__ __forceinline__ int striped(int j) {
  return ((threadIdx.x >> 5) * I + j) * 32 + (threadIdx.x & 31);
}

// The lanes of the warp whose digit equals this lane's: eight ballots, one
// per digit bit (__match_any_sync costs more with every distinct value, and
// random keys give ~30 distinct digits a warp).
__device__ __forceinline__ unsigned match_digit(unsigned d) {
  unsigned peers = 0xFFFFFFFFu;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned bit = (d >> b) & 1u;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, bit);
    peers &= bit ? ballot : ~ballot;
  }
  return peers;
}

// Ranks each item among the earlier items of its warp with the same digit
// (lanes, then chunks), handing local(j, rank) the rank of item j; on
// return cnt[w * 256 + d] holds the items of warp w with digit d
// (warp-major: the lanes of a warp touch different digits, so different
// banks).  Ends with a barrier.
template <int I, typename Local>
__device__ __forceinline__ void warp_rank(const uint32_t (&key)[I], int shift, int* cnt, Local local) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < kDigits * nw; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < I; ++j) {
    const unsigned d = (key[j] >> shift) & 0xFFu;
    const unsigned peers = match_digit(d);
    const unsigned below = peers & lower;
    const int base = cnt[warp * kDigits + d];
    __syncwarp();
    if (below == 0) cnt[warp * kDigits + d] = base + __popc(peers);
    __syncwarp();
    local(j, base + __popc(below));
  }
  __syncthreads();
}

// Multi-block route: turns the counts into each (digit, warp)'s first place
// in the segment, per digit from tile_base[d * tiles] (the scanned
// (digit, tile) counts, already offset by the tile) over the tile's warps.
// Ends with a barrier.
__device__ __forceinline__ void digit_offsets(int* cnt, const int* tile_base, int tiles) {
  const int nw = blockDim.x >> 5;
  for (int d = threadIdx.x; d < kDigits; d += blockDim.x) {
    int run = tile_base[(size_t)d * tiles];
    for (int w = 0; w < nw; ++w) {
      const int c = cnt[w * kDigits + d];
      cnt[w * kDigits + d] = run;
      run += c;
    }
  }
  __syncthreads();
}

// The first place of digit d for this thread's warp, once the counts are
// turned into offsets.
__device__ __forceinline__ int warp_offset(const int* cnt, uint32_t key, int shift) {
  return cnt[(threadIdx.x >> 5) * kDigits + ((key >> shift) & 0xFFu)];
}

// AND and OR of the block's real items (place < n), block-wide.
template <int I>
__device__ __forceinline__ void block_and_or(const uint32_t (&key)[I], int n, uint32_t* and_or) {
  uint32_t a = 0xFFFFFFFFu, o = 0u;
#pragma unroll
  for (int j = 0; j < I; ++j)
    if (striped<I>(j) < n) {
      a &= key[j];
      o |= key[j];
    }
  a = __reduce_and_sync(0xFFFFFFFFu, a);
  o = __reduce_or_sync(0xFFFFFFFFu, o);
  if (threadIdx.x == 0) {
    and_or[0] = 0xFFFFFFFFu;
    and_or[1] = 0u;
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    atomicAnd(and_or, a);
    atomicOr(and_or + 1, o);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The cluster route: one thread-block cluster sorts a segment, its blocks
// exchanging items through distributed shared memory.
// ---------------------------------------------------------------------------

// Threads of a block that holds n items (a multiple of 32).
__host__ __device__ __forceinline__ int block_threads(int n) {
  const int warps = (n + 32 * kClusterItems - 1) / (32 * kClusterItems);
  return 32 * (warps > 0 ? warps : 1);
}

// The cluster for n <= kCapacity items: as many blocks as there are warps'
// worth of items, at most kClusterMax (so 20,000 items take 8 blocks of
// 320 threads, one SM each), and the threads each block needs.
struct Shape {
  int blocks, threads;
};

__host__ __forceinline__ Shape cluster_shape(int n) {
  int blocks = (n + 32 * kClusterItems - 1) / (32 * kClusterItems);
  blocks = blocks < 1 ? 1 : (blocks > kClusterMax ? kClusterMax : blocks);
  return Shape{blocks, block_threads((n + blocks - 1) / blocks)};
}

// Raises `kernel`'s dynamic shared-memory limit to what the cluster route
// needs at most, once per device (the limit stays with the function).
template <typename Kernel>
__host__ cudaError_t allow_block_smem(Kernel* kernel) {
  static bool done[64] = {};  // by device; setting it twice is harmless
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)block_smem_bytes(kBlockThreads));
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

// Launches `kernel` as grid (shape.blocks, y) in clusters of shape.blocks.
template <typename... Params, typename... Args>
__host__ cudaError_t launch_cluster(void (*kernel)(Params...), Shape shape, unsigned y, cudaStream_t s,
                                    Args... args) {
  cudaError_t e = allow_block_smem(kernel);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(shape.blocks, y, 1);
  cfg.blockDim = dim3(shape.threads, 1, 1);
  cfg.dynamicSmemBytes = block_smem_bytes(shape.threads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = shape.blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Items a block of the cluster holds; block r holds places
// [r * span, (r + 1) * span) of the current order.
__device__ __forceinline__ int block_span() { return blockDim.x * kClusterItems; }

// Loads segment `seg` of `src` into the thread's items (pad items beyond n
// carry the top key; they stay behind every real item).
template <typename Src>
__device__ __forceinline__ void load_block(const Src& src, int seg, int n, uint32_t (&key)[kClusterItems],
                                           int (&idx)[kClusterItems]) {
  const int first = (int)cg::this_cluster().block_rank() * block_span();
#pragma unroll
  for (int j = 0; j < kClusterItems; ++j) {
    const int i = first + striped<kClusterItems>(j);
    key[j] = i < n ? src.key(seg, i) : kPadKey;
    idx[j] = i;
  }
}

// A place of the cluster's order, in the shared memory of the block that
// holds it.
template <typename T>
__device__ __forceinline__ T* place_ptr(cg::cluster_group& cl, T* local, int pos) {
  const int span = block_span();
  const int owner = pos / span;
  return cl.map_shared_rank(local, owner) + (pos - owner * span);
}

// Per digit, the first place of each warp of this block in the cluster's
// order: digits in turn, and for one digit the blocks by rank, then the
// warps.  Reads the digit totals every block pushed into this one's
// shared memory.  Ends with a barrier.
__device__ __forceinline__ void cluster_offsets(cg::cluster_group& cl, const Shared& sh) {
  const int nw = blockDim.x >> 5, r = cl.block_rank(), blocks = cl.num_blocks();
  for (int d = threadIdx.x; d < kDigits; d += blockDim.x) {
    int before = 0, all = 0;
    for (int c = 0; c < blocks; ++c) {
      const int t = sh.tot[c * kDigits + d];
      all += t;
      if (c < r) before += t;
    }
    sh.before[d] = before;
    sh.all[d] = all;
  }
  __syncthreads();
  const int dpt = (kDigits + blockDim.x - 1) / blockDim.x;
  const int d0 = min(kDigits, (int)threadIdx.x * dpt), d1 = min(kDigits, d0 + dpt);
  int sum = 0;
  for (int d = d0; d < d1; ++d) sum += sh.all[d];
  int run = block_exclusive_sum(sum, sh.scratch);
  for (int d = d0; d < d1; ++d) {
    int at = run + sh.before[d];
    for (int w = 0; w < nw; ++w) {
      const int c = sh.cnt[w * kDigits + d];
      sh.cnt[w * kDigits + d] = at;
      at += c;
    }
    run += sh.all[d];
  }
  __syncthreads();
}

// Sorts the cluster's n items stably by key.  Every pass but the last
// exchanges keys and indices through the blocks' shared memory; the last
// one hands each item to final(index, place) instead, and ends with a
// cluster barrier (what final wrote anywhere in the cluster is visible).
template <typename Final>
__device__ __forceinline__ void cluster_sort(uint32_t (&key)[kClusterItems], int (&idx)[kClusterItems], int n,
                                             const Shared& sh, Final final) {
  cg::cluster_group cl = cg::this_cluster();
  const int r = cl.block_rank(), blocks = cl.num_blocks();
  const int nw = blockDim.x >> 5;
  block_and_or(key, n - r * block_span(), sh.and_or);
  cl.sync();
  if (threadIdx.x == 0) {
    uint32_t a = 0xFFFFFFFFu, o = 0u;
    for (int c = 0; c < blocks; ++c) {
      a &= *cl.map_shared_rank(sh.and_or, c);
      o |= *cl.map_shared_rank(sh.and_or + 1, c);
    }
    sh.and_or[2] = a;
    sh.and_or[3] = o;
  }
  __syncthreads();
  const unsigned active = active_passes(sh.and_or[2], sh.and_or[3]);
  constexpr int kIdxMask = (1 << kIdxBits) - 1;
  for (int p = 0; p < 4; ++p) {
    if (!((active >> p) & 1u)) continue;
    const int shift = 8 * p;
    const bool last = (active >> (p + 1)) == 0u;
    warp_rank(key, shift, sh.cnt, [&](int j, int rk) { idx[j] |= rk << kIdxBits; });
    // This block's digit totals, pushed into every block of the cluster.
    for (int d = threadIdx.x; d < kDigits; d += blockDim.x) {
      int t = 0;
      for (int w = 0; w < nw; ++w) t += sh.cnt[w * kDigits + d];
      for (int c = 0; c < blocks; ++c) *cl.map_shared_rank(sh.tot + r * kDigits + d, c) = t;
    }
    // Every block's totals have arrived, and every block has read back the
    // previous pass: the buffers may be written.
    cl.sync();
    cluster_offsets(cl, sh);
#pragma unroll
    for (int j = 0; j < kClusterItems; ++j) {
      const int pos = warp_offset(sh.cnt, key[j], shift) + (idx[j] >> kIdxBits);
      idx[j] &= kIdxMask;
      if (last) {
        final(idx[j], pos);
      } else {
        *place_ptr(cl, sh.keys, pos) = key[j];
        *place_ptr(cl, sh.idx, pos) = idx[j];
      }
    }
    // Every item has arrived.
    cl.sync();
    if (last) return;
#pragma unroll
    for (int j = 0; j < kClusterItems; ++j) {
      key[j] = sh.keys[striped<kClusterItems>(j)];
      idx[j] = sh.idx[striped<kClusterItems>(j)];
    }
  }
}

// ---------------------------------------------------------------------------
// The multi-block route.
// ---------------------------------------------------------------------------

// Views into the workspace of one call: `segs` independent sorts of n keys.
struct Work {
  uint32_t* keys[2];  // (segs, n) each, ping-pong
  int* idx[2];        // (segs, n) each, ping-pong; the last holds the order
  int* counts;        // (segs, 256, tiles): digit counts, then their scan
  uint32_t* tile_and_or;  // (segs, tiles, 2)
  uint32_t* meta;     // (segs, 2): AND and OR of all keys
  int* ends;          // (segs, tiles, 2): per-tile row carries (crowding)
  int n, segs, tiles;
};

__host__ __device__ __forceinline__ int num_tiles(int n) { return (int)(((long long)n + kTile - 1) / kTile); }

// Bytes of workspace a call needs: 0 on the one-block route.
__host__ __forceinline__ long long work_bytes(int n, int segs) {
  if (n <= kCapacity) return 0;
  const long long t = num_tiles(n), s = segs;
  return 16LL * s * n + 4LL * s * kDigits * t + 8LL * s * t + 8LL * s + 8LL * s * t;
}

__host__ __forceinline__ Work carve(void* ws, int n, int segs) {
  Work w;
  w.n = n;
  w.segs = segs;
  w.tiles = num_tiles(n);
  const long long sn = (long long)segs * n;
  char* p = (char*)ws;
  w.keys[0] = (uint32_t*)p;
  w.keys[1] = w.keys[0] + sn;
  w.idx[0] = (int*)(w.keys[1] + sn);
  w.idx[1] = w.idx[0] + sn;
  w.counts = w.idx[1] + sn;
  w.tile_and_or = (uint32_t*)(w.counts + (long long)segs * kDigits * w.tiles);
  w.meta = w.tile_and_or + 2LL * segs * w.tiles;
  w.ends = (int*)(w.meta + 2LL * segs);
  return w;
}

// Pass p of the segment: whether it runs, and which buffer it reads.
struct PassPlan {
  unsigned active;
  bool runs, last;
  int src;
};

__device__ __forceinline__ PassPlan pass_plan(const Work& w, int seg, int p) {
  PassPlan pl;
  pl.active = active_passes(w.meta[2 * seg], w.meta[2 * seg + 1]);
  pl.runs = (pl.active >> p) & 1u;
  pl.last = (pl.active >> (p + 1)) == 0u;
  pl.src = __popc(pl.active & ((1u << p) - 1u)) & 1;
  return pl;
}

// The buffer of idx that holds the finished order of a segment.
__device__ __forceinline__ int final_buffer(const Work& w, int seg) {
  return __popc(active_passes(w.meta[2 * seg], w.meta[2 * seg + 1])) & 1;
}

// Keys of every element into keys[0], indices into idx[0], and each tile's
// AND / OR.  Grid (tiles, segs).
template <typename Src>
__global__ void __launch_bounds__(kTileThreads) mb_keys(Src src, Work w) {
  __shared__ uint32_t and_or[2];
  const int seg = blockIdx.y, tile = blockIdx.x;
  const long long base = (long long)seg * w.n;
  const long long lo = (long long)tile * kTile, hi = min((long long)w.n, lo + kTile);
  uint32_t a = 0xFFFFFFFFu, o = 0u;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const uint32_t k = src.key(seg, (int)i);
    w.keys[0][base + i] = k;
    w.idx[0][base + i] = (int)i;
    a &= k;
    o |= k;
  }
  a = __reduce_and_sync(0xFFFFFFFFu, a);
  o = __reduce_or_sync(0xFFFFFFFFu, o);
  if (threadIdx.x == 0) {
    and_or[0] = 0xFFFFFFFFu;
    and_or[1] = 0u;
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    atomicAnd(and_or, a);
    atomicOr(and_or + 1, o);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long t = (long long)seg * w.tiles + tile;
    w.tile_and_or[2 * t] = and_or[0];
    w.tile_and_or[2 * t + 1] = and_or[1];
  }
}

// AND / OR over a segment's tiles into meta.  Grid (segs), kScanThreads.
__global__ void __launch_bounds__(kScanThreads) mb_plan(Work w) {
  __shared__ uint32_t and_or[2];
  const int seg = blockIdx.x;
  uint32_t a = 0xFFFFFFFFu, o = 0u;
  for (int t = threadIdx.x; t < w.tiles; t += blockDim.x) {
    const long long e = (long long)seg * w.tiles + t;
    a &= w.tile_and_or[2 * e];
    o |= w.tile_and_or[2 * e + 1];
  }
  a = __reduce_and_sync(0xFFFFFFFFu, a);
  o = __reduce_or_sync(0xFFFFFFFFu, o);
  if (threadIdx.x == 0) {
    and_or[0] = 0xFFFFFFFFu;
    and_or[1] = 0u;
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    atomicAnd(and_or, a);
    atomicOr(and_or + 1, o);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    w.meta[2 * seg] = and_or[0];
    w.meta[2 * seg + 1] = and_or[1];
  }
}

// A tile's items in warp-striped order from buffer `src` (pad: top key,
// index -1).
__device__ __forceinline__ void load_tile(const Work& w, int seg, int tile, int src, uint32_t (&key)[kItems],
                                          int (&idx)[kItems]) {
  const long long base = (long long)seg * w.n;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = (long long)tile * kTile + striped<kItems>(j);
    const bool real = i < w.n;
    key[j] = real ? w.keys[src][base + i] : kPadKey;
    idx[j] = real ? w.idx[src][base + i] : -1;
  }
}

// Pass p: each tile's digit counts into counts[seg][d][tile].
// Grid (tiles, segs), kTileThreads.
__global__ void __launch_bounds__(kTileThreads) mb_count(Work w, int p) {
  __shared__ int cnt[kDigits * (kTileThreads / 32)];
  const int seg = blockIdx.y, tile = blockIdx.x;
  const PassPlan pl = pass_plan(w, seg, p);
  if (!pl.runs) return;
  uint32_t key[kItems];
  int idx[kItems];
  load_tile(w, seg, tile, pl.src, key, idx);
  warp_rank(key, 8 * p, cnt, [](int, int) {});
  const int nw = blockDim.x >> 5;
  int* out = w.counts + (long long)seg * kDigits * w.tiles + tile;
  for (int d = threadIdx.x; d < kDigits; d += blockDim.x) {
    int sum = 0;
    for (int q = 0; q < nw; ++q) sum += cnt[q * kDigits + d];
    out[(long long)d * w.tiles] = sum;
  }
}

// Pass p: exclusive scan of a segment's (digit, tile) counts in place.
// Grid (segs), kScanThreads.
__global__ void __launch_bounds__(kScanThreads) mb_scan(Work w, int p) {
  __shared__ int scratch[33];
  __shared__ int chunk_total;
  const int seg = blockIdx.x;
  if (!pass_plan(w, seg, p).runs) return;
  int* c = w.counts + (long long)seg * kDigits * w.tiles;
  const long long len = (long long)kDigits * w.tiles;
  int carry = 0;
  for (long long b = 0; b < len; b += (long long)kScanThreads * kScanItems) {
    const long long i0 = b + (long long)threadIdx.x * kScanItems;
    int v[kScanItems];
    int sum = 0;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      v[j] = i0 + j < len ? c[i0 + j] : 0;
      sum += v[j];
    }
    int run = block_exclusive_sum(sum, scratch) + carry;
    if (threadIdx.x == blockDim.x - 1) chunk_total = run + sum;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      if (i0 + j < len) c[i0 + j] = run;
      run += v[j];
    }
    __syncthreads();
    carry = chunk_total;
    __syncthreads();
  }
}

// Pass p: stable scatter of each tile into the other buffer.  On the last
// pass run, kRank writes rank[index] = place; otherwise only the index is
// written, at its place (the finished order).
// Grid (tiles, segs), kTileThreads.
template <bool kRank>
__global__ void __launch_bounds__(kTileThreads) mb_scatter(Work w, int p, int* rank) {
  __shared__ int cnt[kDigits * (kTileThreads / 32)];
  __shared__ int local[kTile];  // each item's rank in its warp
  const int seg = blockIdx.y, tile = blockIdx.x;
  const PassPlan pl = pass_plan(w, seg, p);
  if (!pl.runs) return;
  uint32_t key[kItems];
  int idx[kItems];
  load_tile(w, seg, tile, pl.src, key, idx);
  const int shift = 8 * p;
  warp_rank(key, shift, cnt, [&](int j, int r) { local[striped<kItems>(j)] = r; });
  digit_offsets(cnt, w.counts + (long long)seg * kDigits * w.tiles + tile, w.tiles);
  const long long base = (long long)seg * w.n;
  const int dst = 1 - pl.src;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (idx[j] < 0) continue;  // pad item
    const int pos = warp_offset(cnt, key[j], shift) + local[striped<kItems>(j)];
    if (!pl.last) {
      w.keys[dst][base + pos] = key[j];
      w.idx[dst][base + pos] = idx[j];
    } else if (kRank) {
      rank[idx[j]] = pos;
    } else {
      w.idx[dst][base + pos] = idx[j];
    }
  }
}

// Launches the multi-block sort of `segs` segments of n keys from `src`:
// 2 + 3 x 4 kernels.  Returns the first launch error.
template <typename Src>
__host__ cudaError_t mb_sort(const Src& src, const Work& w, int* rank, bool write_rank, cudaStream_t s) {
  const dim3 tiles(w.tiles, w.segs);
  mb_keys<Src><<<tiles, kTileThreads, 0, s>>>(src, w);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mb_plan<<<w.segs, kScanThreads, 0, s>>>(w);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  for (int p = 0; p < 4; ++p) {
    mb_count<<<tiles, kTileThreads, 0, s>>>(w, p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    mb_scan<<<w.segs, kScanThreads, 0, s>>>(w, p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if (write_rank)
      mb_scatter<true><<<tiles, kTileThreads, 0, s>>>(w, p, rank);
    else
      mb_scatter<false><<<tiles, kTileThreads, 0, s>>>(w, p, nullptr);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace radix

// The one-block route's largest n (the crossover), for the wrappers' tests.
extern "C" int radix_block_capacity() { return radix::kCapacity; }
