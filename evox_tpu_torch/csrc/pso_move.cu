// Fused PSO move on Hopper (sm_90a).
//
// Replaces the TPU kernel `_pso_move_kernel` of evox_tpu/ops/pso_step.py
// (Pallas, called through `fused_pso_move`).  One pass over the (N, D)
// population does the personal-best fold, the two U[0, 1) draws, the
// velocity/position update and the bound clamps:
//
//   improved = f32(fit) < f32(lbf)               (per row; NaN gives false)
//   lbl'     = improved ? x : lbl
//   lbf'     = improved ? fit : lbf              (one thread per row writes it)
//   v'       = ((w*v) + ((phi_p*rp)*(lbl'-x))) + ((phi_g*rg)*(gbl-x))
//   x'       = min(max(x + v', lb), ub)          (NaN stays NaN)
//   v'       = min(max(v', lb), ub)
//
// Every operation is done in float32 and, for bfloat16, rounded to
// bfloat16 after it, in the order above; that is how the plain PyTorch
// version (evox_tpu_torch/ops/pso_step.py) rounds, eager operator by
// operator.  The build passes --fmad=false and the code uses the _rn
// intrinsics, so no multiply-add is contracted and float32 agrees with
// the plain version bit for bit.
//
// Draws: with rand_input != 0, rp and rg are read from tensors.  Otherwise
// they come from Philox4x32-10 (csrc/philox.cuh), countered by the element
// index (row * D + col): word 0 gives rp, word 1 gives rg.  The Philox key
// is read from the device: child `index` of the key tensor [seed, counter]
// (or its seed word alone, when `derive` is 0), so a replayed CUDA graph
// draws anew from the key the previous generation advanced.
//
// Instances: one launch moves a batch of B independent swarms (a vmapped
// workflow), laid out as (B, N, D) arrays, (B, N) fitness, a (B, D) global
// best, (B, 3) scalars, B keys, and bounds shared or (B, D).  Instance b
// reads key b and counts its Philox counters from 0 (row * D + col within
// the instance), so it draws, and moves, exactly what a launch of that
// instance alone does.  One instance (B = 1) is the unbatched call.  The high 24
// bits (float32) or 7 bits (bfloat16) times 2^-m keep the JAX kernel's bit
// choice, so the upper bound 1 is strict.  evox_tpu_torch/utils/rng.py
// computes the same Philox in PyTorch.
//
// What bounds it on an H100: bytes.  With in-kernel draws it reads pop,
// velocity and local-best once and writes their updates once: 6 * N * D
// elements, 2.4 GB at (100000, 1000) float32, >= 0.72 ms at 3.35 TB/s
// (1.2 GB and >= 0.36 ms in bfloat16).  The arithmetic, Philox included,
// is about a hundred integer and float operations per element, far below
// what the card can issue in that time.  The design moves exactly those
// bytes and nothing else: no draw tensors, one read and one write per
// element, the fold folded into the same pass.  Layout: one block of 256
// threads per row, striding over the columns, so neighbouring threads touch
// neighbouring addresses and any D works (the ragged end is masked by the
// loop bound; no padding).  16-byte vector access and in-place update are
// left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

struct F32 {
  using T = float;
  static constexpr int kBits = 24;
  __device__ __forceinline__ static float load(const T* p, long long i) { return p[i]; }
  __device__ __forceinline__ static float round(float x) { return x; }
  __device__ __forceinline__ static void store(T* p, long long i, float x) { p[i] = x; }
};

struct BF16 {
  using T = __nv_bfloat16;
  static constexpr int kBits = 7;
  __device__ __forceinline__ static float load(const T* p, long long i) {
    return __bfloat162float(p[i]);
  }
  __device__ __forceinline__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ __forceinline__ static void store(T* p, long long i, float x) {
    p[i] = __float2bfloat16_rn(x);
  }
};

// NaN-propagating max/min, as torch.maximum/torch.minimum and jnp.clip
// (fmaxf/fminf would drop the NaN).
__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

template <typename L>
__global__ void __launch_bounds__(kThreads)
pso_move_kernel(const typename L::T* __restrict__ pop,
                const typename L::T* __restrict__ vel,
                const typename L::T* __restrict__ lbl,
                const typename L::T* __restrict__ fit,
                const typename L::T* __restrict__ lbf,
                const typename L::T* __restrict__ gbl,
                const typename L::T* __restrict__ lb,
                const typename L::T* __restrict__ ub,
                const float* __restrict__ scal,
                const typename L::T* __restrict__ rp_in,
                const typename L::T* __restrict__ rg_in,
                typename L::T* __restrict__ pop_out,
                typename L::T* __restrict__ vel_out,
                typename L::T* __restrict__ lbl_out,
                typename L::T* __restrict__ lbf_out,
                long long n, long long d, long long bound_stride,
                const long long* __restrict__ key, int index, int derive, int rand_input) {
  // One block a row of the whole batch: row `local` of instance b.
  const long long row = blockIdx.x;
  const long long b = row / n;
  const long long local = row - b * n;
  const uint64_t seed = rand_input ? 0ull : philox::draw_seed(key + 2 * b, index, derive);
  // The scalars arrive as float32 on the device (no host read of the
  // Parameter leaves); the JAX kernel casts them to the working dtype.
  const float w = L::round(scal[3 * b]);
  const float phi_p = L::round(scal[3 * b + 1]);
  const float phi_g = L::round(scal[3 * b + 2]);
  gbl += b * d;
  lb += b * bound_stride;
  ub += b * bound_stride;

  const float f = L::load(fit, row);
  const float fl = L::load(lbf, row);
  const bool improved = f < fl;
  if (threadIdx.x == 0) L::store(lbf_out, row, improved ? f : fl);

  for (long long col = threadIdx.x; col < d; col += kThreads) {
    const long long i = row * d + col;
    const float x = L::load(pop, i);
    const float v = L::load(vel, i);
    const float l = improved ? x : L::load(lbl, i);
    float rp, rg;
    if (rand_input) {
      rp = L::load(rp_in, i);
      rg = L::load(rg_in, i);
    } else {
      uint32_t words[4];
      philox::philox4x32((unsigned long long)(local * d + col), seed, words);
      rp = philox::uniform_bits(words[0], L::kBits);
      rg = philox::uniform_bits(words[1], L::kBits);
    }
    const float g = L::load(gbl, col);
    const float t1 = L::round(__fmul_rn(w, v));
    const float t2 = L::round(__fmul_rn(L::round(__fmul_rn(phi_p, rp)),
                                        L::round(__fsub_rn(l, x))));
    const float s = L::round(__fadd_rn(t1, t2));
    const float t3 = L::round(__fmul_rn(L::round(__fmul_rn(phi_g, rg)),
                                        L::round(__fsub_rn(g, x))));
    const float vn = L::round(__fadd_rn(s, t3));
    const float xn = L::round(__fadd_rn(x, vn));
    const float lo = L::load(lb, col), hi = L::load(ub, col);
    L::store(lbl_out, i, l);
    L::store(pop_out, i, min_nan(max_nan(xn, lo), hi));
    L::store(vel_out, i, min_nan(max_nan(vn, lo), hi));
  }
}

template <typename L>
int launch(const void* pop, const void* vel, const void* lbl, const void* fit,
           const void* lbf, const void* gbl, const void* lb, const void* ub,
           const void* scal, const void* rp, const void* rg, void* pop_out,
           void* vel_out, void* lbl_out, void* lbf_out, long long batch, long long n,
           long long d, long long bound_stride, const void* key, int index, int derive,
           int rand_input, cudaStream_t stream) {
  using T = typename L::T;
  if (batch * n > 0) {
    pso_move_kernel<L><<<(unsigned int)(batch * n), kThreads, 0, stream>>>(
        (const T*)pop, (const T*)vel, (const T*)lbl, (const T*)fit,
        (const T*)lbf, (const T*)gbl, (const T*)lb, (const T*)ub,
        (const float*)scal, (const T*)rp, (const T*)rg, (T*)pop_out,
        (T*)vel_out, (T*)lbl_out, (T*)lbf_out, n, d, bound_stride, (const long long*)key, index,
        derive, rand_input);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Every pointer is a device pointer to `batch` instances' operands (see
// above): pop/vel/lbl/rp/rg/outputs (batch, n, d), fit/lbf (batch, n), gbl
// (batch, d), scal (batch, 3) float32, key (batch, 2) int64 (see
// csrc/philox.cuh), lb/ub (batch, d) with bound_stride d or one (d,) row
// shared with bound_stride 0.  rp/rg may be null when rand_input == 0, and
// key when it is not.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int pso_move(int dtype, const void* pop, const void* vel,
                        const void* lbl, const void* fit, const void* lbf,
                        const void* gbl, const void* lb, const void* ub,
                        const void* scal, const void* rp, const void* rg,
                        void* pop_out, void* vel_out, void* lbl_out,
                        void* lbf_out, long long batch, long long n, long long d,
                        long long bound_stride, const void* key, int index, int derive,
                        int rand_input, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (batch < 0 || n < 0 || batch * n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<F32>(pop, vel, lbl, fit, lbf, gbl, lb, ub, scal, rp, rg,
                       pop_out, vel_out, lbl_out, lbf_out, batch, n, d, bound_stride,
                       key, index, derive, rand_input, s);
  if (dtype == 1)
    return launch<BF16>(pop, vel, lbl, fit, lbf, gbl, lb, ub, scal, rp, rg,
                        pop_out, vel_out, lbl_out, lbf_out, batch, n, d, bound_stride,
                        key, index, derive, rand_input, s);
  return (int)cudaErrorInvalidValue;
}
