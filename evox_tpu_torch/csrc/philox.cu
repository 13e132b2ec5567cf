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
// Element i (0 <= i < numel) evaluates Philox4x32-10 once, on the counter
// (i_lo, i_hi, 0, 0), and output o takes word o:
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
// key; Philox costs about 80 integer operations an element (ten rounds of
// two 32-bit multiplies, their high halves and four XORs), above the bytes'
// time at 3.35 TB/s.  The design spends nothing else: one evaluation serves
// all four outputs, a grid-stride loop of coalesced stores, no temporaries.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOut = 4;

struct Outputs {
  int count;
  int kind[kMaxOut];
  long long low[kMaxOut];
  long long span[kMaxOut];
  void* ptr[kMaxOut];
};

__device__ __forceinline__ void store(const Outputs& o, int k, long long i, uint32_t word) {
  switch (o.kind[k]) {
    case 0:
      ((float*)o.ptr[k])[i] = philox::uniform_bits(word, 24);
      break;
    case 1:
      ((__nv_bfloat16*)o.ptr[k])[i] = __float2bfloat16_rn(philox::uniform_bits(word, 7));
      break;
    case 2:
      ((double*)o.ptr[k])[i] = (double)philox::uniform_bits(word, 24);
      break;
    case 3:
      ((__half*)o.ptr[k])[i] = __float2half_rn(philox::uniform_bits(word, 24));
      break;
    default:
      ((long long*)o.ptr[k])[i] =
          o.low[k] + (long long)(((unsigned long long)word * (unsigned long long)o.span[k]) >> 32);
      break;
  }
}

// blockIdx.y is the stream: stream b reads key b and writes row b of each
// (batch, numel) output, its Philox counter the element's index i within
// the stream, so stream b draws what a launch of one stream keyed by key b
// draws.
__global__ void __launch_bounds__(kThreads)
philox_draw_kernel(const long long* __restrict__ key, int index, int derive, long long numel,
                   Outputs out) {
  const long long b = blockIdx.y;
  const uint64_t seed = philox::draw_seed(key + 2 * b, index, derive);
  const long long base = b * numel;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < numel; i += stride) {
    uint32_t words[4];
    philox::philox4x32((unsigned long long)i, seed, words);
#pragma unroll
    for (int k = 0; k < kMaxOut; ++k)
      if (k < out.count) store(out, k, base + i, words[k]);
  }
}

}  // namespace

// Plain C entry point for ctypes.  `key` is a device pointer to `batch`
// (2,) int64 keys, one a stream (batch 1: the draws of one key); out0..out3
// are device pointers to batch x `numel` elements each, of the types
// kind0..kind3 (see above; only the first `count` are read); low/span give
// each int64 output its range.  `blocks` is the grid's size for the whole
// batch (the wrapper sizes it by the card's SMs), shared out among the
// streams.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int philox_draw(const void* key, int batch, int index, int derive, long long numel, int count,
                           int kind0, int kind1, int kind2, int kind3, long long low0,
                           long long low1, long long low2, long long low3, long long span0,
                           long long span1, long long span2, long long span3, void* out0,
                           void* out1, void* out2, void* out3, int blocks, void* stream) {
  if (count < 1 || count > kMaxOut || blocks < 1 || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  Outputs o;
  o.count = count;
  const int kinds[kMaxOut] = {kind0, kind1, kind2, kind3};
  const long long lows[kMaxOut] = {low0, low1, low2, low3};
  const long long spans[kMaxOut] = {span0, span1, span2, span3};
  void* ptrs[kMaxOut] = {out0, out1, out2, out3};
  for (int k = 0; k < kMaxOut; ++k) {
    o.kind[k] = kinds[k];
    o.low[k] = lows[k];
    o.span[k] = spans[k];
    o.ptr[k] = ptrs[k];
    if (k < count && (kinds[k] < 0 || kinds[k] > 4 || ptrs[k] == nullptr ||
                      (kinds[k] == 4 && (spans[k] < 1 || spans[k] > (1LL << 31)))))
      return (int)cudaErrorInvalidValue;
  }
  if (numel > 0) {
    const long long want = (numel + kThreads - 1) / kThreads;
    const int per_stream = blocks / batch > 0 ? blocks / batch : 1;
    const dim3 grid(want < per_stream ? (unsigned int)want : (unsigned int)per_stream, (unsigned int)batch);
    philox_draw_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)key, index, derive, numel, o);
  }
  return (int)cudaGetLastError();
}
