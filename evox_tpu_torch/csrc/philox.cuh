// Philox4x32-10 and the port's key derivation, shared by the draw kernel
// (csrc/philox.cu) and the fused PSO move (csrc/pso_move.cu).
//
// A key is a (2,) int64 tensor [seed, counter] on the device
// (evox_tpu_torch/utils/rng.py).  Child `index` of a key is the 64-bit
// Philox key splitmix64(seed ^ splitmix64(counter + index)); the kernels
// read the key from device memory and derive the child themselves, so no
// host reads a key and a replayed CUDA graph draws from the key's current
// value.  utils/rng.py computes the same functions in PyTorch.

#pragma once

#include <stdint.h>

namespace philox {

__host__ __device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  uint64_t z = x + 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// The Philox key of a draw: child `index` of `key` when `derive` is set,
// else key[0] itself (a seed given as a plain integer).
__device__ __forceinline__ uint64_t draw_seed(const long long* key, int index, int derive) {
  const uint64_t seed = (uint64_t)key[0];
  if (!derive) return seed;
  return splitmix64(seed ^ splitmix64((uint64_t)key[1] + (uint64_t)(long long)index));
}

// Philox4x32-10 (Salmon et al., SC'11; Random123's constants) of the
// counter (lo, hi, 0, 0) under the 64-bit key `seed`: the four output words.
__device__ __forceinline__ void philox4x32(unsigned long long counter, uint64_t seed,
                                           uint32_t out[4]) {
  uint32_t c0 = (uint32_t)counter, c1 = (uint32_t)(counter >> 32), c2 = 0u, c3 = 0u;
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

// U[0, 1) from a word: its high `bits` bits times 2^-bits (24 for float32,
// 7 for bfloat16), exact in float32.
__device__ __forceinline__ float uniform_bits(uint32_t word, int bits) {
  return __fmul_rn((float)(word >> (32 - bits)), __int_as_float((127 - bits) << 23));
}

}  // namespace philox
