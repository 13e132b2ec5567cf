// Exact lexicographic rank by a stable radix sort, on Hopper (sm_90a).
//
// Replaces the TPU kernel `_rank_kernel` of evox_tpu/ops/topk.py (Pallas,
// called through `lex_rank` and `masked_top_k`).  For every element i:
//
//   rank[i] = #{ j : (v[j], j) < (v[i], i) }
//
// under the strict total order of a stable ascending sort: NaN after +inf,
// all NaNs equal to each other, -0.0 equal to +0.0, ties broken by index.
// The ranks are a permutation of 0..n-1, the stable-sort position of each
// element.  float32 and int32.
//
// What bounds it on an H100: bytes (4n in, 4n out; a sort needs only
// n log2 n compares).  The TPU kernel counted all n^2 pairs; here each
// value becomes its 32-bit order key (radix_sort.cuh) and the keys are
// sorted stably with the index as payload.  Digit passes on which every key
// agrees are skipped on the device: the NSGA-II path's int32 ranks (0..~30
// and the sentinel n) need two of the four.  Up to radix::kCapacity
// elements one thread-block cluster sorts in distributed shared memory and
// writes the order, and a second kernel over the whole card scatters
// rank[order[p]] = p (scattered stores from a few SMs are slow); beyond,
// the multi-block route of radix_sort.cuh, whose last pass writes the ranks.
// The `out[rank] = i` scatter of masked_top_k is left to the wrapper.

#include "radix_sort.cuh"

namespace {

struct FloatSrc {
  const float* v;
  __device__ uint32_t key(int, int i) const { return radix::float_key(v[i]); }
};

struct IntSrc {
  const int* v;
  __device__ uint32_t key(int, int i) const { return radix::int_key(v[i]); }
};

// The cluster route: sorts the n elements and writes their stable order
// (the index at each place), coalesced.
template <typename Src>
__global__ void __launch_bounds__(radix::kBlockThreads, 1) lex_order_cluster(Src src, int n, int* __restrict__ order) {
  extern __shared__ __align__(16) unsigned char smem[];
  const radix::Shared sh = radix::block_shared(smem);
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  uint32_t key[radix::kClusterItems];
  int idx[radix::kClusterItems];
  radix::load_block(src, 0, n, key, idx);
  radix::cluster_sort(key, idx, n, sh, [&](int i, int pos) { *radix::place_ptr(cl, sh.idx, pos) = i; });
  const int first = (int)cl.block_rank() * radix::block_span();
  for (int p = threadIdx.x; p < radix::block_span() && first + p < n; p += blockDim.x) order[first + p] = sh.idx[p];
}

// rank[order[p]] = p over the whole card (the stores are scattered, which
// the cluster's few SMs would do slowly).
__global__ void __launch_bounds__(256) rank_from_order(const int* __restrict__ order, int n, int* __restrict__ rank) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n) rank[order[p]] = p;
}

template <typename Src>
int launch(Src src, int n, int* rank, void* ws, cudaStream_t s) {
  if (n <= 0) return (int)cudaGetLastError();
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  if (n <= radix::kCapacity) {
    int* order = (int*)ws;
    cudaError_t e = radix::launch_cluster(lex_order_cluster<Src>, radix::cluster_shape(n), 1, s, src, n, order);
    if (e != cudaSuccess) return (int)e;
    rank_from_order<<<(n + 255) / 256, 256, 0, s>>>(order, n, rank);
    return (int)cudaGetLastError();
  }
  return (int)radix::mb_sort(src, radix::carve(ws, n, 1), rank, true, s);
}

}  // namespace

// Bytes of device workspace `lex_rank` needs for n elements: the order up
// to radix::kCapacity, the multi-block sort's buffers beyond.
extern "C" long long lex_rank_workspace(int n) {
  return n <= radix::kCapacity ? 4LL * n : radix::work_bytes(n, 1);
}

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = int32.  `rank`:
// (n,) int32, every entry written.  `workspace`: lex_rank_workspace(n)
// bytes.  Two launches up to radix::kCapacity elements.  No host
// synchronisation.  Returns the first launch error, or cudaSuccess.
extern "C" int lex_rank(int dtype, const void* v, int n, void* rank, void* workspace, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch(FloatSrc{(const float*)v}, n, (int*)rank, workspace, s);
  if (dtype == 1) return launch(IntSrc{(const int*)v}, n, (int*)rank, workspace, s);
  return (int)cudaErrorInvalidValue;
}
