// Per-objective lexicographic neighbours for the crowding distance, by a
// stable radix sort per objective, on Hopper (sm_90a).
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
// The design: per objective, ALL n rows (masked-out ones too: the contract
// gives them neighbours among the valid rows) are sorted stably by the
// 32-bit order key of their value (radix_sort.cuh).  Combined (key, row)
// pairs are distinct and the sort orders them exactly, so the predecessor
// of the row at sorted place p is the last valid row before p (an
// exclusive forward scan that carries the last valid row seen) and the
// successor the first valid row after p (the same scan backward).  The
// neighbour's value is read back as it is, so NaN and a real +-inf stay
// exact, and the flags are plain 0/1 (the TPU kernel needed the encodings
// has_below 2/1/0 and has_above 1/0.5/0 instead).  The m objectives are
// independent sorts along the grid.
//
// What bounds it on an H100: bytes (4nm in, n of mask, 16nm out; the sort
// needs only n log2 n compares a column).  Up to radix::kCapacity rows one
// thread-block cluster per objective sorts in distributed shared memory
// and scans the sorted rows into three coalesced lists (order,
// predecessor, successor); beyond, the
// multi-block sort of radix_sort.cuh and three kernels (per-tile ends, a
// one-block scan of them per objective, the per-tile scans) write the same
// lists.  A last kernel over the whole card turns the lists into the four
// outputs: their stores are scattered by row, which a few SMs would do
// slowly.  So two launches up to radix::kCapacity rows.

#include <limits.h>
#include <math_constants.h>

#include "radix_sort.cuh"

namespace {

struct CostSrc {
  const float* costs;
  int m;
  __device__ uint32_t key(int k, int i) const { return radix::float_key(costs[(long long)i * m + k]); }
};

// For the sorted places [lo, hi) of one objective (order[p - lo] = row at
// place p): out_order[p] = that row, pred[p] = the last valid row before p,
// succ[p] = the first valid row after p (-1: none), with fwd_in the last
// valid row before lo and bwd_in the first valid row at or after hi.
// Places are warp-striped as in the sort (radix::striped): in each chunk a
// ballot of the valid lanes gives every lane its nearest valid lane below
// and above, the warp carries the rest from chunk to chunk, and one
// block scan carries it from warp to warp; every store is coalesced.
// I: places a thread takes (as in the sort).  Every thread of the block must
// call it.
template <int I>
__device__ void scan_neighbors(const int* order, const unsigned char* __restrict__ mask, long long lo,
                               long long hi, int fwd_in, int bwd_in, int* scratch, int* __restrict__ out_order,
                               int* __restrict__ pred, int* __restrict__ succ) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u, higher = ~((2u << lane) - 1u);
  int row[I];
  int warp_last = -1, warp_first = -1;
#pragma unroll
  for (int j = 0; j < I; ++j) {
    const long long p = lo + radix::striped<I>(j);
    row[j] = p < hi ? order[p - lo] : -1;
    const unsigned b = __ballot_sync(0xFFFFFFFFu, row[j] >= 0 && mask[row[j]]);
    if (b) warp_last = __shfl_sync(0xFFFFFFFFu, row[j], 31 - __clz(b));
  }
#pragma unroll
  for (int j = I - 1; j >= 0; --j) {
    const unsigned b = __ballot_sync(0xFFFFFFFFu, row[j] >= 0 && mask[row[j]]);
    if (b) warp_first = __shfl_sync(0xFFFFFFFFu, row[j], __ffs(b) - 1);
  }
  // The last valid row of the warps before this one, the first of those after.
  int carry = __shfl_sync(0xFFFFFFFFu, radix::block_last_row<false>(lane == 31 ? warp_last : -1, scratch), 0);
  if (carry < 0) carry = fwd_in;
#pragma unroll
  for (int j = 0; j < I; ++j) {
    const unsigned b = __ballot_sync(0xFFFFFFFFu, row[j] >= 0 && mask[row[j]]);
    const unsigned below = b & lower;
    const int near = __shfl_sync(0xFFFFFFFFu, row[j], below ? 31 - __clz(below) : lane);
    const long long p = lo + radix::striped<I>(j);
    if (p < hi) {
      out_order[p] = row[j];
      pred[p] = below ? near : carry;
    }
    if (b) carry = __shfl_sync(0xFFFFFFFFu, row[j], 31 - __clz(b));
  }
  carry = __shfl_sync(0xFFFFFFFFu, radix::block_last_row<true>(lane == 0 ? warp_first : -1, scratch), 31);
  if (carry < 0) carry = bwd_in;
#pragma unroll
  for (int j = I - 1; j >= 0; --j) {
    const unsigned b = __ballot_sync(0xFFFFFFFFu, row[j] >= 0 && mask[row[j]]);
    const unsigned above = b & higher;
    const int near = __shfl_sync(0xFFFFFFFFu, row[j], above ? __ffs(above) - 1 : lane);
    const long long p = lo + radix::striped<I>(j);
    if (p < hi) succ[p] = above ? near : carry;
    if (b) carry = __shfl_sync(0xFFFFFFFFu, row[j], __ffs(b) - 1);
  }
}

// The neighbour lists of the m objectives, (order, pred, succ), each (m, n)
// int32, at the start of the workspace.
struct Lists {
  int *order, *pred, *succ;
};

__host__ __device__ inline Lists lists(void* ws, long long total) {
  int* base = (int*)ws;
  return Lists{base, base + total, base + 2 * total};
}

// The cluster route: cluster k sorts objective k and writes its lists.
// Each block scans the places it holds, with the last valid row of the
// blocks before it and the first of those after it as carries.
__global__ void __launch_bounds__(radix::kBlockThreads, 1)
neighbors_cluster(const float* __restrict__ costs, const unsigned char* __restrict__ mask, int n, int m,
                  Lists out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const radix::Shared sh = radix::block_shared(smem);
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const int k = blockIdx.y, r = cl.block_rank(), blocks = cl.num_blocks();
  uint32_t key[radix::kClusterItems];
  int idx[radix::kClusterItems];
  radix::load_block(CostSrc{costs, m}, k, n, key, idx);
  radix::cluster_sort(key, idx, n, sh, [&](int i, int pos) { *radix::place_ptr(cl, sh.idx, pos) = i; });
  // The first and last valid places this block holds.
  const int first = r * radix::block_span();
  const int held = max(0, min(n - first, radix::block_span()));
  int lo = INT_MAX, hi = -1;
  for (int p = threadIdx.x; p < held; p += blockDim.x)
    if (mask[sh.idx[p]]) {
      lo = min(lo, p);
      hi = p;
    }
  lo = __reduce_min_sync(0xFFFFFFFFu, lo);
  hi = __reduce_max_sync(0xFFFFFFFFu, hi);
  if (threadIdx.x == 0) {
    sh.xch[0] = INT_MAX;
    sh.xch[1] = -1;
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    atomicMin(sh.xch, lo);
    atomicMax(sh.xch + 1, hi);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sh.xch[2] = sh.xch[0] < INT_MAX ? sh.idx[sh.xch[0]] : -1;
    sh.xch[3] = sh.xch[1] >= 0 ? sh.idx[sh.xch[1]] : -1;
  }
  cl.sync();
  int fwd = -1, bwd = -1;
  for (int c = r - 1; c >= 0 && fwd < 0; --c) fwd = *cl.map_shared_rank(sh.xch + 3, c);
  for (int c = r + 1; c < blocks && bwd < 0; ++c) bwd = *cl.map_shared_rank(sh.xch + 2, c);
  cl.sync();  // no block leaves while another reads its words
  const long long at = (long long)k * n;
  scan_neighbors<radix::kClusterItems>(sh.idx, mask, first, first + held, fwd, bwd, sh.scratch, out.order + at, out.pred + at,
                 out.succ + at);
}

// Both routes, last: the four outputs from the lists, one (objective,
// place) a thread over the whole card (the rows are scattered).  Values are
// read back as they are (NaN, a real +-inf); a missing neighbour gives
// -inf / +inf with its flag 0.
__global__ void __launch_bounds__(256)
neighbor_values(Lists in, long long total, int n, int m, const float* __restrict__ costs,
                float* __restrict__ below_v, float* __restrict__ above_v, float* __restrict__ has_below,
                float* __restrict__ has_above) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int k = (int)(t / n);
  const int r = in.order[t], lo = in.pred[t], hi = in.succ[t];
  const long long e = (long long)r * m + k;
  below_v[e] = lo >= 0 ? costs[(long long)lo * m + k] : -CUDART_INF_F;
  above_v[e] = hi >= 0 ? costs[(long long)hi * m + k] : CUDART_INF_F;
  has_below[e] = lo >= 0 ? 1.0f : 0.0f;
  has_above[e] = hi >= 0 ? 1.0f : 0.0f;
}

// Multi-block route, after the sort: each tile's last and first valid row
// into ends.  Grid (tiles, m), kTileThreads.
__global__ void __launch_bounds__(radix::kTileThreads)
tile_ends(radix::Work w, const unsigned char* __restrict__ mask) {
  using radix::kItems;
  __shared__ int scratch[64];
  const int k = blockIdx.y, tile = blockIdx.x;
  const int* order = w.idx[radix::final_buffer(w, k)] + (long long)k * w.n;
  const long long p0 = (long long)tile * radix::kTile + (long long)threadIdx.x * kItems;
  int last = -1, first = -1;
  for (int j = 0; j < kItems; ++j) {
    const long long p = p0 + j;
    if (p < w.n) {
      const int r = order[p];
      if (mask[r]) {
        last = r;
        if (first < 0) first = r;
      }
    }
  }
  const int before = radix::block_last_row<false>(last, scratch);
  const int after = radix::block_last_row<true>(first, scratch);
  const long long e = 2 * ((long long)k * w.tiles + tile);
  if (threadIdx.x == blockDim.x - 1) w.ends[e] = last >= 0 ? last : before;
  if (threadIdx.x == 0) w.ends[e + 1] = first >= 0 ? first : after;
}

// Multi-block route: per objective, replaces each tile's ends by its carries
// (the last valid row of the tiles before it, the first of the tiles after
// it).  Grid (m), kScanThreads.
__global__ void __launch_bounds__(radix::kScanThreads) tile_carries(radix::Work w) {
  __shared__ int scratch[64];
  __shared__ int chunk_end;
  const int k = blockIdx.x;
  int* ends = w.ends + 2 * (long long)k * w.tiles;
  const int chunks = (w.tiles + blockDim.x - 1) / blockDim.x;
  int carry = -1;
  for (int c = 0; c < chunks; ++c) {
    const int t = c * blockDim.x + threadIdx.x;
    const int v = t < w.tiles ? ends[2 * t] : -1;
    int ex = radix::block_last_row<false>(v, scratch);
    if (ex < 0) ex = carry;
    if (threadIdx.x == blockDim.x - 1) chunk_end = v >= 0 ? v : ex;
    if (t < w.tiles) ends[2 * t] = ex;
    __syncthreads();
    carry = chunk_end;
    __syncthreads();
  }
  carry = -1;
  for (int c = chunks - 1; c >= 0; --c) {
    const int t = c * blockDim.x + threadIdx.x;
    const int v = t < w.tiles ? ends[2 * t + 1] : -1;
    int ex = radix::block_last_row<true>(v, scratch);
    if (ex < 0) ex = carry;
    if (threadIdx.x == 0) chunk_end = v >= 0 ? v : ex;
    if (t < w.tiles) ends[2 * t + 1] = ex;
    __syncthreads();
    carry = chunk_end;
    __syncthreads();
  }
}

// Multi-block route: the lists of each tile of sorted places.
// Grid (tiles, m), kTileThreads.
__global__ void __launch_bounds__(radix::kTileThreads)
neighbors_tiles(radix::Work w, const unsigned char* __restrict__ mask, Lists out) {
  __shared__ int scratch[64];
  const int k = blockIdx.y, tile = blockIdx.x;
  const long long at = (long long)k * w.n;
  const int* order = w.idx[radix::final_buffer(w, k)] + at;
  const long long lo = (long long)tile * radix::kTile;
  const long long hi = min((long long)w.n, lo + radix::kTile);
  const long long e = 2 * ((long long)k * w.tiles + tile);
  scan_neighbors<radix::kItems>(order + lo, mask, lo, hi, w.ends[e], w.ends[e + 1], scratch, out.order + at, out.pred + at,
                 out.succ + at);
}

}  // namespace

// Bytes of device workspace `crowding_neighbors` needs for (n, m) costs:
// the neighbour lists, and beyond radix::kCapacity rows the multi-block
// sort's buffers after them.
extern "C" long long crowding_workspace(int n, int m) {
  return 12LL * n * m + radix::work_bytes(n, m);
}

// Plain C entry point for ctypes.  costs: (n, m) float32; mask: (n,) bool;
// outputs (n, m) float32: neighbour values and 0/1 existence flags, every
// entry written.  `workspace`: crowding_workspace(n, m) bytes.  Two
// launches up to radix::kCapacity rows.  No host synchronisation.  Returns
// the first launch error, or cudaSuccess.
extern "C" int crowding_neighbors(const void* costs, const void* mask, int n, int m, void* workspace,
                                  void* below_v, void* above_v, void* has_below, void* has_above,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m <= 0 || m > 65535) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  if (workspace == nullptr) return (int)cudaErrorInvalidValue;
  const float* c = (const float*)costs;
  const unsigned char* mk = (const unsigned char*)mask;
  const long long total = (long long)n * m;
  const Lists l = lists(workspace, total);
  cudaError_t e;
  if (n <= radix::kCapacity) {
    e = radix::launch_cluster(neighbors_cluster, radix::cluster_shape(n), m, s, c, mk, n, m, l);
    if (e != cudaSuccess) return (int)e;
  } else {
    const radix::Work w = radix::carve((char*)workspace + 12 * total, n, m);
    if ((e = radix::mb_sort(CostSrc{c, m}, w, nullptr, false, s)) != cudaSuccess) return (int)e;
    const dim3 tiles(w.tiles, m);
    tile_ends<<<tiles, radix::kTileThreads, 0, s>>>(w, mk);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    tile_carries<<<m, radix::kScanThreads, 0, s>>>(w);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    neighbors_tiles<<<tiles, radix::kTileThreads, 0, s>>>(w, mk, l);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  neighbor_values<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      l, total, n, m, c, (float*)below_v, (float*)above_v, (float*)has_below, (float*)has_above);
  return (int)cudaGetLastError();
}
