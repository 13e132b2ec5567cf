// Philox draws on Hopper (sm_90a): up to four draws of one shape in one
// launch, each written in its final form.
//
// The port's own kernel: the JAX package draws with the TPU's PRNG inside
// XLA programs and has no Pallas kernel for it.  It replaces the plain
// PyTorch draws of evox_tpu_torch/utils/rng.py (`philox_words` followed by
// `uniform_bits` / `randint_bits`), which evaluate Philox4x32-10 in int64
// tensor operations: about 150 launches an evaluation and 8 bytes a word
// of temporaries.
//
// Element i (0 <= i < numel) of a stream evaluates Philox4x32-10 once, on
// the counter (i_lo, i_hi, 0, 0), and output o takes word o:
//   kind 0 float32, 1 bfloat16, 2 float64, 3 float16: U[0, 1), the high 24
//     bits (7 for bfloat16) times 2^-m, exact in float32, then rounded to
//     the output type (as `.to(dtype)` rounds);
//   kind 4 int64: low + ((word * span) >> 32), span in 1..2^31.
// The Philox key is read from the device (csrc/philox.cuh): child `index`
// of the (2,) int64 key [seed, counter], or key[0] itself when `derive` is
// 0.  So no host reads a key, and a replayed CUDA graph draws from the key
// the previous generation advanced.
//
// What bounds it on an H100: operations.  It writes each output once (4
// bytes an element for float32, 8 for int64) and reads nothing else but the
// key; Philox costs ten rounds of two 32x32 -> 64-bit multiplies and two
// three-way XORs an element, and Hopper issues the multiplies (IMAD.WIDE)
// at a fraction of the lane rate, well above the bytes' time at 3.35 TB/s.
// So the design issues nothing else it can avoid:
//   * the vector route: a thread makes kVec = 4 consecutive elements as four
//     interleaved, independent Philox chains, and stores each output as one
//     16-byte vector (8 bytes for bfloat16 and float16, two 16-byte stores
//     for float64 and int64); vectors are aligned in the flat (batch, numel)
//     output, so only the vector at each end of a stream stores by element;
//     the first round's multiplies of the four consecutive counters are one
//     product and three subtractions;
//   * a block draws for one stream (grid row `blockIdx.y`): ten of its
//     lanes derive the key and its ten round keys once into shared memory,
//     read a round at a time (32 registers a thread: eight blocks an SM);
//   * the scalar route, for draws small enough to be latency-bound (up to
//     two blocks an SM in all): a thread an element, deriving its key itself
//     with no barrier, as one chain ends sooner than four;
//   * the grid is planned on the host (ops/philox.py `_launch_plan`): one
//     vector a thread in blocks of at most 128 where that fits in two waves
//     of the resident blocks, narrower blocks for small streams so that a
//     stream reaches every SM; else a stream's vectors over its share of the
//     resident blocks in whole grid-stride passes, so that no stream's tail
//     adds a serial pass;
//   * the number of outputs is a template argument (the last round computes
//     only the words stored) and each output's kind is read once a vector;
//     32-bit indices below 2^31 elements in all, 64-bit ones above.
// Its times are PERF.md's rows `philox_draws` and `philox_draws_batched`.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOut = 4;
constexpr int kVec = 4;     // consecutive elements a thread makes: interleaved chains
constexpr int kRounds = 10;
constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // philox.cuh's multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // and key increments

struct Outputs {
  int kind[kMaxOut];
  long long low[kMaxOut];
  long long span[kMaxOut];
  void* ptr[kMaxOut];
};

// V Philox4x32-10 chains at once, on the counters (c0[e], c1[e], 0, 0),
// with round r keyed by (k0[r], k1[r]): philox.cuh's philox4x32 with the key
// schedule taken out.  Written round by round across the chains, so each
// round issues 2 * V independent multiplies.
//
// With `consecutive` (the counters' low words c0[e] = c0[V-1] - (V-1-e), no
// word wrapping between them for any element that is stored), the first
// round's one product M0 * c0[e] is M0 * c0[V-1] less the constant
// (V-1-e) * M0: a 64-bit subtraction in place of V-1 multiplies.
template <int V, bool Consecutive>
__device__ __forceinline__ void philox_chains(const uint32_t (&c0)[V], const uint32_t (&c1)[V], const uint32_t* k0,
                                              const uint32_t* k1, uint32_t (&w)[V][4]) {
  uint32_t hi[V], lo[V];
  const unsigned long long last = (unsigned long long)kM0 * c0[V - 1];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if (Consecutive) {
      const unsigned long long p = last - (unsigned long long)(V - 1 - e) * kM0;
      hi[e] = (uint32_t)(p >> 32);
      lo[e] = (uint32_t)p;
    } else {
      hi[e] = __umulhi(kM0, c0[e]);
      lo[e] = kM0 * c0[e];
    }
    // Round 0 on (c0, c1, 0, 0): the second product is 0.
    w[e][0] = c1[e] ^ k0[0];
    w[e][1] = 0u;
    w[e][2] = hi[e] ^ k1[0];
    w[e][3] = lo[e];
  }
#pragma unroll
  for (int r = 1; r < kRounds; ++r) {
    const uint32_t key0 = k0[r], key1 = k1[r];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const uint32_t hi0 = __umulhi(kM0, w[e][0]), lo0 = kM0 * w[e][0];
      const uint32_t hi1 = __umulhi(kM1, w[e][2]), lo1 = kM1 * w[e][2];
      const uint32_t n0 = hi1 ^ w[e][1] ^ key0, n2 = hi0 ^ w[e][3] ^ key1;
      w[e][0] = n0;
      w[e][1] = lo1;
      w[e][2] = n2;
      w[e][3] = lo0;
    }
  }
}

// kVec values as one store of 16 bytes (two for 8-byte types, 8 bytes for
// 16-bit ones).
__device__ __forceinline__ void store_vec(float* p, const float (&x)[kVec]) {
  *(float4*)p = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store_vec(double* p, const double (&x)[kVec]) {
  ((double2*)p)[0] = make_double2(x[0], x[1]);
  ((double2*)p)[1] = make_double2(x[2], x[3]);
}
__device__ __forceinline__ void store_vec(long long* p, const long long (&x)[kVec]) {
  ((longlong2*)p)[0] = make_longlong2(x[0], x[1]);
  ((longlong2*)p)[1] = make_longlong2(x[2], x[3]);
}
__device__ __forceinline__ void store_vec(unsigned short* p, const unsigned short (&x)[kVec]) {
  *(uint2*)p = make_uint2((uint32_t)x[0] | ((uint32_t)x[1] << 16), (uint32_t)x[2] | ((uint32_t)x[3] << 16));
}

// V values at p: one vector store when V is kVec and all lie in the
// stream, else each value whose element does (`in`).
template <int V, typename T>
__device__ __forceinline__ void put(T* p, const T (&x)[V], bool full, const bool (&in)[V]) {
  if constexpr (V == kVec) {
    if (full) {
      store_vec(p, x);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e)
    if (in[e]) p[e] = x[e];
}

// Output k of one vector: elements f0 .. f0 + V - 1 of the flat output,
// whose stream indices are i0 .. i0 + V - 1; `full` when all lie in the
// stream (0 <= i < n).
template <int V, typename I>
__device__ __forceinline__ void store_output(const Outputs& o, int k, I f0, long long i0, long long n, bool full,
                                             const uint32_t (&w)[V][4]) {
  bool in[V];
#pragma unroll
  for (int e = 0; e < V; ++e) in[e] = full || (i0 + e >= 0 && i0 + e < n);
  switch (o.kind[k]) {
    case 0: {
      float x[V];
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = philox::uniform_bits(w[e][k], 24);
      put<V>((float*)o.ptr[k] + f0, x, full, in);
      break;
    }
    case 1: {
      unsigned short x[V];
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = __bfloat16_as_ushort(__float2bfloat16_rn(philox::uniform_bits(w[e][k], 7)));
      put<V>((unsigned short*)o.ptr[k] + f0, x, full, in);
      break;
    }
    case 2: {
      double x[V];
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = (double)philox::uniform_bits(w[e][k], 24);
      put<V>((double*)o.ptr[k] + f0, x, full, in);
      break;
    }
    case 3: {
      unsigned short x[V];
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = __half_as_ushort(__float2half_rn(philox::uniform_bits(w[e][k], 24)));
      put<V>((unsigned short*)o.ptr[k] + f0, x, full, in);
      break;
    }
    default: {
      long long x[V];
#pragma unroll
      for (int e = 0; e < V; ++e)
        x[e] = o.low[k] + (long long)(((unsigned long long)w[e][k] * (unsigned long long)o.span[k]) >> 32);
      put<V>((long long*)o.ptr[k] + f0, x, full, in);
      break;
    }
  }
}

// Blocks an SM the vector route is compiled for (registers: at most 32 a
// thread, the round keys in shared memory).
constexpr int kVecBlocksPerSm = 8;

// Grid (blocks, batch): row b draws stream b, reading key b and writing row
// b of each (batch, numel) output, its Philox counter the element's index
// within the stream, so stream b draws what a launch of one stream keyed by
// key b draws.  Vector v of the stream covers flat elements V * (first +
// v) .., first = floor(b * numel / V); a thread takes vectors v, v +
// stride, ... (`I`: uint32_t below 2^31 elements in all, else 64-bit).
template <int Count, bool Wide, int V>
__global__ void __launch_bounds__(kThreads, V == kVec ? kVecBlocksPerSm : 1)
philox_draw_kernel(const long long* __restrict__ key, int index, int derive, long long numel, Outputs out) {
  using I = typename std::conditional<Wide, unsigned long long, uint32_t>::type;
  __shared__ uint32_t round_keys[2][kRounds];
  const int b = blockIdx.y;
  uint32_t held[2][kRounds];
  const uint32_t* k0 = round_keys[0];
  const uint32_t* k1 = round_keys[1];
  if constexpr (V == 1) {
    // A thread an element: latency-bound, so each thread derives its key
    // itself (no barrier) and keeps the round keys in registers.
    const uint64_t seed = philox::draw_seed(key + 2 * b, index, derive);
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      held[0][r] = (uint32_t)seed + r * kW0;
      held[1][r] = (uint32_t)(seed >> 32) + r * kW1;
    }
    k0 = held[0];
    k1 = held[1];
  } else {
    // Ten lanes derive the key and its round keys once for the block;
    // each round reads its two keys from shared memory.
    if (threadIdx.x < kRounds) {
      const uint64_t seed = philox::draw_seed(key + 2 * b, index, derive);
      round_keys[0][threadIdx.x] = (uint32_t)seed + threadIdx.x * kW0;
      round_keys[1][threadIdx.x] = (uint32_t)(seed >> 32) + threadIdx.x * kW1;
    }
    __syncthreads();
  }
  const I n = (I)numel;
  const I lo = (I)b * n;  // the stream's first flat element
  const I first = lo / V;
  const I vectors = (lo + n + (V - 1)) / V - first;
  const I stride = (I)gridDim.x * blockDim.x;
  for (I v = (I)blockIdx.x * blockDim.x + threadIdx.x; v < vectors; v += stride) {
    const I f0 = (first + v) * V;
    // The vector's first index in the stream: -3 .. -1 for a vector that
    // starts in the stream before.
    const long long i0 = Wide ? (long long)(f0 - lo) : (long long)(int)(f0 - lo);
    uint32_t c0[V], c1[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const long long i = i0 + e;
      c0[e] = (uint32_t)i;
      c1[e] = Wide ? (uint32_t)((unsigned long long)i >> 32) : 0u;
    }
    uint32_t w[V][4];
    // Consecutive low counter words below 2^31 (no wrap) on the 32-bit route.
    philox_chains<V, !Wide>(c0, c1, k0, k1, w);
    const bool full = i0 >= 0 && i0 <= (long long)numel - V;
#pragma unroll
    for (int k = 0; k < Count; ++k) store_output<V>(out, k, f0, i0, numel, full, w);
  }
}

using Kernel = void (*)(const long long*, int, int, long long, Outputs);

template <int V>
Kernel kernel_of_vec(int count, int wide) {
  switch (count * 2 + (wide ? 1 : 0)) {
    case 2: return philox_draw_kernel<1, false, V>;
    case 3: return philox_draw_kernel<1, true, V>;
    case 4: return philox_draw_kernel<2, false, V>;
    case 5: return philox_draw_kernel<2, true, V>;
    case 6: return philox_draw_kernel<3, false, V>;
    case 7: return philox_draw_kernel<3, true, V>;
    case 8: return philox_draw_kernel<4, false, V>;
    case 9: return philox_draw_kernel<4, true, V>;
    default: return nullptr;
  }
}

Kernel kernel_of(int count, int wide, int vec) {
  return vec == kVec ? kernel_of_vec<kVec>(count, wide) : vec == 1 ? kernel_of_vec<1>(count, wide) : nullptr;
}

}  // namespace

// Blocks of the kernel for `count` outputs (1..4), 64-bit indices when
// `wide`, `vec` elements a thread (1 or 4), that one SM holds at once; -1
// for no such kernel.
extern "C" int philox_blocks_per_sm(int count, int wide, int vec) {
  const Kernel k = kernel_of(count, wide, vec);
  int blocks = 0;
  if (k == nullptr || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads, 0) != cudaSuccess)
    return -1;
  return blocks;
}

// Plain C entry point for ctypes.  `key` is a device pointer to `batch`
// (2,) int64 keys, one a stream (batch 1: the draws of one key); out0..out3
// are device pointers to batch x `numel` elements each, 16-byte aligned, of
// the types kind0..kind3 (see above; only the first `count` are read);
// low/span give each int64 output its range.  The launch plan
// (ops/philox.py `_launch_plan`): `vec` elements a thread (1 or kVec),
// `blocks` blocks of `threads` (a multiple of 32, at most kThreads) a
// stream, 64-bit indices when `wide` (required from 2^31 elements in all).  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for operands or a plan the kernel does not take.
extern "C" int philox_draw(const void* key, int batch, int index, int derive, long long numel, int count,
                           int kind0, int kind1, int kind2, int kind3, long long low0,
                           long long low1, long long low2, long long low3, long long span0,
                           long long span1, long long span2, long long span3, void* out0,
                           void* out1, void* out2, void* out3, int vec, int threads, int blocks,
                           int wide, void* stream) {
  if (count < 1 || count > kMaxOut || batch < 1 || batch > 65535 || numel < 0 ||
      (!wide && (long long)batch * numel >= (1LL << 31)))
    return (int)cudaErrorInvalidValue;
  if (numel == 0) return (int)cudaGetLastError();
  Outputs o;
  const int kinds[kMaxOut] = {kind0, kind1, kind2, kind3};
  const long long lows[kMaxOut] = {low0, low1, low2, low3};
  const long long spans[kMaxOut] = {span0, span1, span2, span3};
  void* ptrs[kMaxOut] = {out0, out1, out2, out3};
  for (int k = 0; k < kMaxOut; ++k) {
    o.kind[k] = kinds[k];
    o.low[k] = lows[k];
    o.span[k] = spans[k];
    o.ptr[k] = ptrs[k];
    if (k < count && (kinds[k] < 0 || kinds[k] > 4 || ptrs[k] == nullptr || (uintptr_t)ptrs[k] % 16 != 0 ||
                      (kinds[k] == 4 && (spans[k] < 1 || spans[k] > (1LL << 31)))))
      return (int)cudaErrorInvalidValue;
  }
  const Kernel fn = kernel_of(count, wide, vec);
  if (fn == nullptr || blocks < 1 || threads < kRounds || threads > kThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const long long* k = (const long long*)key;
  void* args[] = {(void*)&k, (void*)&index, (void*)&derive, (void*)&numel, (void*)&o};
  const cudaError_t e = cudaLaunchKernel((const void*)fn, dim3((unsigned int)blocks, (unsigned int)batch),
                                         dim3((unsigned int)threads), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
